"""Which correspondence kernel runs on which platform.

This is the one module that asks JAX for the platform.  Every other module
that needs a backend-dependent choice asks here, through
:func:`nn_method` (the solver's correspondence route, via
``ICPConfig.resolved_nn_method``) or :func:`bruteforce_kernel` (how the
tiled brute-force 1-NN is computed).

Routes for an (n queries, m targets) problem:

* ``dense``   n*m <= DENSE_MAX_PAIRS: one (n, m) distance matrix (XLA).
* ``cluster`` m >= CLUSTER_MIN_TARGET: Hilbert cluster-pruned certified
              search (ops/cluster_knn, XLA).
* ``pallas``  the mid range, where a compiled tiled brute-force kernel
              exists (ops/pallas_knn through Triton, GPU only).  Elsewhere
              the mid range goes to ``cluster``.

Nothing here chooses the Pallas interpreter: interpret mode is only ever
requested explicitly by a caller (the CPU tests).
"""

from __future__ import annotations

from typing import Optional

DENSE_MAX_PAIRS = 4096 * 4096
CLUSTER_MIN_TARGET = 16384

# Platforms for which ops/pallas_knn compiles (Pallas through Triton).
_TRITON_PLATFORMS = ("gpu",)


def platform() -> str:
    """The default JAX backend's platform name ('cpu', 'gpu', ...)."""
    import jax

    return jax.default_backend()


def bruteforce_kernel(plat: Optional[str] = None) -> str:
    """How the tiled brute-force 1-NN runs on ``plat`` (default: here).

    'triton': the compiled Pallas kernel (ops/pallas_knn).
    'xla':    the streaming difference-form argmin (knn.nn_argmin_stream),
              which never materializes (n, m) either.
    """
    plat = platform() if plat is None else plat
    return "triton" if plat in _TRITON_PLATFORMS else "xla"


def nn_method(n: int, m: int, plat: Optional[str] = None) -> str:
    """Correspondence route ('dense' | 'pallas' | 'cluster') for an (n, m)
    problem on ``plat`` (default: here)."""
    if n * m <= DENSE_MAX_PAIRS:
        return "dense"
    if m >= CLUSTER_MIN_TARGET or bruteforce_kernel(plat) != "triton":
        return "cluster"
    return "pallas"
