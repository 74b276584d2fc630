"""The one backend rule (dicp_tpu.backend) and what routes through it."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from dicp_tpu import backend, knn
from dicp_tpu.config import ICPConfig

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "dicp_tpu")

MID = 8192          # 8192^2 > DENSE_MAX_PAIRS, target below CLUSTER_MIN_TARGET
BIG = 100_000


@pytest.mark.parametrize("plat,n,m,route", [
    ("cpu", 65, 65, "dense"),
    ("gpu", 65, 65, "dense"),
    ("cpu", 4096, 4096, "dense"),
    ("gpu", 4096, 4096, "dense"),
    ("cpu", MID, MID, "cluster"),
    ("gpu", MID, MID, "pallas"),
    ("cpu", BIG, BIG, "cluster"),
    ("gpu", BIG, BIG, "cluster"),
    ("gpu", BIG, MID, "pallas"),
    ("gpu", 2000, 16384, "cluster"),
    ("rocm", MID, MID, "cluster"),
])
def test_nn_method_rule(plat, n, m, route):
    assert backend.nn_method(n, m, plat) == route


@pytest.mark.parametrize("plat,kernel", [("gpu", "triton"), ("cpu", "xla"),
                                         ("rocm", "xla")])
def test_bruteforce_kernel_by_platform(plat, kernel):
    assert backend.bruteforce_kernel(plat) == kernel


def test_config_asks_the_backend(monkeypatch):
    """resolved_nn_method follows the platform rule; explicit choices and
    the legacy switch still win."""
    cfg = ICPConfig()
    assert cfg.resolved_nn_method(MID, MID) == backend.nn_method(MID, MID)
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert cfg.resolved_nn_method(MID, MID) == "pallas"
    assert cfg.with_(nn_method="dense").resolved_nn_method(MID, MID) == "dense"
    assert cfg.with_(use_pallas_nn=False).resolved_nn_method(MID, MID) == "dense"


def test_only_backend_asks_for_the_platform():
    """No module but dicp_tpu/backend.py calls jax.default_backend()."""
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            src = open(path).read()
            if "default_backend(" in src and f != "backend.py":
                offenders.append(path)
    assert offenders == []


def test_pallas_kernel_never_interprets_unless_asked():
    """Without interpret=True the Triton kernel refuses the CPU instead of
    silently running in the interpreter."""
    from dicp_tpu.ops.pallas_knn import nn_distances_pallas

    x = jnp.zeros((5, 3), jnp.float32)
    with pytest.raises(ValueError, match="interpret"):
        nn_distances_pallas(x, x + 1.0)
    idx, _ = nn_distances_pallas(x, x + 1.0, bq=8, bt=8, interpret=True)
    assert idx.shape == (5,)


def test_bruteforce_dispatches_to_the_platform_kernel(monkeypatch):
    """nn_bruteforce: the Triton kernel where the platform compiles it, the
    XLA streaming argmin elsewhere (never the interpreter)."""
    import dicp_tpu.ops.pallas_knn as pk

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(40, 3)))
    y = jnp.asarray(rng.normal(size=(70, 3)))
    ref = np.argmin(np.sum((np.asarray(x)[:, None] - np.asarray(y)[None]) ** 2,
                           -1), 1)
    idx, d2 = knn.nn_bruteforce(x, y)                       # cpu: XLA stream
    np.testing.assert_array_equal(np.asarray(idx), ref)

    calls = []
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(pk, "nn_distances_pallas",
                        lambda a, b: calls.append(a.shape) or (idx, d2))
    knn.nn_bruteforce(x, y)
    assert calls == [(40, 3)]


def test_large_bruteforce_never_materializes(monkeypatch):
    """Above DENSE_MAX_PAIRS find_nn_normalized streams (no hard_nn, whose
    matmul form builds (n, m)) and matches the dense answer."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 30, 3)))
    y = jnp.asarray(rng.normal(size=(2, 50, 6)))
    dense = knn.hard_nn(x, y)
    monkeypatch.setattr(knn, "DENSE_MAX_PAIRS", 100)

    def boom(*a):
        raise AssertionError("dense path taken")

    monkeypatch.setattr(knn, "hard_nn", boom)
    out = knn.find_nn_normalized(x, y)
    np.testing.assert_allclose(np.asarray(out), np.asarray(dense))


def test_min_and_lowest_id_single_pass_ties():
    d2 = jnp.asarray([[3.0, 1.0, 1.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    ids = jnp.asarray([7, 9, 4, 1])
    m, i = knn.min_and_lowest_id(d2, ids)
    np.testing.assert_array_equal(np.asarray(m), [1.0, 5.0])
    np.testing.assert_array_equal(np.asarray(i), [4, 1])


def test_stream_ids_tie_to_lowest_id():
    """nn_argmin_stream across chunks: exact ties resolve to the lowest id,
    even when the lower id sits in a later chunk."""
    y = jnp.asarray(np.ones((10, 3)))
    ids = jnp.asarray([9, 8, 7, 6, 5, 4, 3, 2, 1, 0])
    bid, best = knn.nn_argmin_stream(jnp.zeros((2, 3)), y, chunk=3, ids=ids)
    np.testing.assert_array_equal(np.asarray(bid), [0, 0])
    np.testing.assert_allclose(np.asarray(best), [3.0, 3.0])
