"""Tiled Pallas-Triton 1-NN kernel vs the brute-force reference.

Here the kernel runs in the Pallas interpreter, which must be asked for;
the compiled kernel is checked on the GPU by chip_smoke.py and by the
``gpu``-marked test below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dicp_tpu import knn
from dicp_tpu.ops.pallas_knn import nn_distances_pallas, nn_indices_pallas


@pytest.mark.parametrize("n,m", [(65, 65), (130, 300), (257, 2049)])
def test_matches_bruteforce(n, m):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 5)
    y = jnp.asarray(rng.normal(size=(m, 3)).astype(np.float32) * 5)
    idx = nn_indices_pallas(x, y, bq=64, bt=256, interpret=True)
    ref = knn.nn_indices(x.astype(jnp.float64), y.astype(jnp.float64))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref))


def test_distances():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(70, 3)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(90, 3)).astype(np.float32))
    idx, d2 = nn_distances_pallas(x, y, bq=64, bt=64, interpret=True)
    gathered = np.asarray(y)[np.asarray(idx)]
    expected = np.sum((np.asarray(x) - gathered) ** 2, axis=-1)
    np.testing.assert_allclose(np.asarray(d2), expected, rtol=1e-4, atol=1e-5)


def test_batched_vmap():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(3, 40, 3)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(3, 50, 3)).astype(np.float32))
    idx = nn_indices_pallas(x, y, bq=64, bt=64, interpret=True)
    assert idx.shape == (3, 40)
    ref = knn.nn_indices(x, y)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref))


def test_padding_never_wins():
    """Target padding rows (+1e30) must never be selected, even when real
    points are far away — replaces the reference's 1000x sentinel trick."""
    x = jnp.asarray(np.array([[1e4, 1e4, 1e4]], dtype=np.float32))
    y = jnp.asarray(np.zeros((5, 3), dtype=np.float32))
    idx = nn_indices_pallas(x, y, bq=8, bt=256, interpret=True)  # pads m 5->256
    assert int(idx[0]) in range(5)


def test_tie_resolves_to_first():
    x = jnp.asarray(np.zeros((1, 3), dtype=np.float32))
    y = jnp.asarray(np.ones((300, 3), dtype=np.float32))  # all equidistant
    idx = nn_indices_pallas(x, y, bq=8, bt=64, interpret=True)
    assert int(idx[0]) == 0


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(gpu):
    """The compiled Triton kernel (no interpreter) vs the plain argmin."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-50, 50, (4096, 3)).astype(np.float32))
    y = jnp.asarray(rng.uniform(-50, 50, (5000, 3)).astype(np.float32))
    idx, d2 = nn_distances_pallas(x, y)
    dense = jnp.sum((x[:, None, :] - y[None, :, :]) ** 2, axis=-1)
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.asarray(jnp.argmin(dense, axis=1)))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(jnp.min(dense, 1)),
                               rtol=1e-6)
