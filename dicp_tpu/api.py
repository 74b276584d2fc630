"""Drop-in user API: the ``ICP`` class and ragged-input batch handling.

Mirrors the reference's public surface (dICP/ICP.py:14-511) so a dICP user
can switch with only an import change, while the compute path underneath is
the jitted core in :mod:`dicp_tpu.registration`.

Input normalization (the reference's ``batch_size_handling``,
dICP/ICP.py:305-511) runs eagerly with jnp ops: every ragged-list element
has a concrete Python length, so padding to one static shape is trace-safe
and *differentiable* — gradients flow back into each original list element,
matching the reference where ``backward()`` reaches every input tensor.
Semantics reproduced exactly:

* ragged sources zero-padded with zero weights (dICP/ICP.py:386-426);
* targets padded with ``max(source) * target_pad_val`` so pads never win the
  NN search (dICP/ICP.py:460-482);
* empty/None clouds become phony single-point clouds with zero weight, which
  makes the Gauss-Newton step an exact no-op and returns T_init unchanged
  (dICP/ICP.py:331-346; the reference returns identity here, which is
  indistinguishable in its tests since they pass T_init = I — we preserve
  the passed T_init, strictly more useful);
* optional per-point prior weights, lists allowed, None means ones
  (dICP/ICP.py:321-326).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dicp_tpu.config import ICPConfig, config_from_yaml, load_yaml_config
from dicp_tpu.registration import ICPResult, register_jit, slice_histories


def _is_empty(x) -> bool:
    return x is None or (hasattr(x, "__len__") and len(x) == 0)


def _result_dtype(target_list):
    for t in target_list:
        if not _is_empty(t):
            return jnp.asarray(t).dtype
    return jnp.float32


def batch_size_handling(
    source,
    target,
    T_init=None,
    weight=None,
    target_pad_val: float = 1000.0,
    keep_source_normals: bool = False,
    soft_nn: bool = False,
):
    """Normalize (possibly ragged) inputs to dense batched jnp arrays.

    Returns (source (N,n,3|6), target (N,m,3|6), T_init (N,4,4) or None,
    weight (N,n)).  Unlike the reference (dICP/ICP.py:508-509) the weight is
    NOT pt2pt-expanded here — the functional core does that internally.

    ``keep_source_normals`` preserves 6-column sources (required by
    symmetric ICP, which reads source normals; the reference normalizer
    always strips them, dICP/ICP.py:371).

    Ragged-target padding: with hard NN (``soft_nn=False``) pad rows REPEAT
    the cloud's last real row — every hard backend's tie rule picks the
    lowest(-original) row, so a pad can never change a result, and the
    rows stay inside the real bounding box (the reference's distant
    sentinel, dICP/ICP.py:460, collapses the cluster index's Hilbert
    quantization frame to 1-2 cells and silently corrupts large ragged
    registrations — code-review r3).  ``soft_nn=True`` (Gumbel) keeps the
    far sentinel: the softmax gives duplicated rows probability mass, while
    a distant sentinel's is ~0.
    """
    src_cols = 6 if keep_source_normals else 3
    # ---- phony path: entire source/target missing (dICP/ICP.py:329-346)
    if _is_empty(source) or _is_empty(target):
        dt = jnp.float32
        ti = jnp.eye(4, dtype=dt)[None] if T_init is None else _normalize_T(T_init, dt)
        # phony clouds sized to the T_init batch, so a batched T_init passes
        # through unchanged instead of shape-crashing in the solver
        N = ti.shape[0]
        src = jnp.zeros((N, 1, src_cols), dtype=dt)
        tgt = jnp.zeros((N, 1, 6), dtype=dt)
        w = jnp.zeros((N, 1), dtype=dt)
        return src, tgt, ti, w

    # mixed list/dense inputs: the reference handles source and target lists
    # independently (dICP/ICP.py:361-426 vs :440-485); normalize by lifting
    # the dense side to a list so one code path serves both.
    is_list_src = isinstance(source, (list, tuple))
    is_list_tgt = isinstance(target, (list, tuple))
    if is_list_src != is_list_tgt:
        if is_list_src:
            t = jnp.asarray(target)
            if t.ndim == 2:
                target = [t] * len(source)          # one shared target cloud
            elif t.ndim == 3:
                target = [t[i] for i in range(t.shape[0])]
            else:
                raise ValueError("target must be (m x 3/6) or (N x m x 3/6) or list")
        else:
            s = jnp.asarray(source)
            if s.ndim == 2:
                source = [s] * len(target)          # one shared source cloud
                if weight is not None and jnp.asarray(weight).ndim == 1:
                    weight = [weight] * len(target)
            elif s.ndim == 3:
                source = [s[i] for i in range(s.shape[0])]
                if weight is not None and jnp.asarray(weight).ndim == 2:
                    weight = [weight[i] for i in range(len(source))]
            else:
                raise ValueError("source must be (n x 3/6) or (N x n x 3/6) or list")

    is_list = isinstance(source, (list, tuple))
    # Validate batch-length agreement up front: a dense (N, n, 3) source
    # lifted against an M != N target list (or a short weight list) would
    # otherwise surface as an opaque stack/einsum shape error in the solver.
    if is_list and len(source) != len(target):
        raise ValueError(
            f"source and target batch lengths disagree: {len(source)} source "
            f"clouds vs {len(target)} target clouds")
    if weight is not None:
        if is_list:
            if len(source) != len(weight):
                raise ValueError(
                    f"weight batch length {len(weight)} != source batch "
                    f"length {len(source)}")
        else:
            if jnp.asarray(source).shape[0] != jnp.asarray(weight).shape[0]:
                raise ValueError(
                    f"weight has {jnp.asarray(weight).shape[0]} rows but "
                    f"source has {jnp.asarray(source).shape[0]}")

    if is_list:
        dt = _result_dtype(target)
        n_max = max(max((len(s) if not _is_empty(s) else 1) for s in source), 1)
        src_rows, w_rows = [], []
        for i, s in enumerate(source):
            if _is_empty(s):
                src_rows.append(jnp.zeros((n_max, src_cols), dtype=dt))
                w_rows.append(jnp.zeros((n_max,), dtype=dt))
                continue
            s = jnp.asarray(s, dtype=dt)
            if s.ndim != 2 or s.shape[1] not in (3, 6):
                raise ValueError("source list must contain (n x 3/6) tensors")
            if keep_source_normals and s.shape[1] != 6:
                raise ValueError("symmetric ICP requires 6-column sources "
                                 "(coordinates + normals); got shape "
                                 f"{tuple(s.shape)}")
            ni = s.shape[0]
            src_rows.append(jnp.concatenate(
                [s[:, :src_cols],
                 jnp.zeros((n_max - ni, src_cols), dtype=dt)], axis=0))
            if weight is not None and weight[i] is not None:
                wi = jnp.asarray(weight[i], dtype=dt)
                if wi.shape[0] != ni:
                    raise ValueError(
                        f"weight[{i}] has {wi.shape[0]} rows but source[{i}] "
                        f"has {ni} — per-cloud weights must align row-wise")
            else:
                wi = jnp.ones((ni,), dtype=dt)
            w_rows.append(jnp.concatenate([wi, jnp.zeros((n_max - ni,), dtype=dt)]))
        src = jnp.stack(src_rows)
        w = jnp.stack(w_rows)

        # target: pad with a sentinel far from any source point (dICP/ICP.py:460)
        tgt_dim = None
        for t in target:
            if not _is_empty(t):
                tgt_dim = jnp.asarray(t).shape[1]
                break
        if tgt_dim is None:
            tgt_dim = 6
        m_max = max(max((len(t) if not _is_empty(t) else 1) for t in target), 1)
        # sentinel guaranteed far outside the cloud: the reference's
        # max(source)*1000 (dICP/ICP.py:460) lands AT the origin when all
        # coordinates are <= 0 and pad rows silently win the NN search
        pad_val = (jnp.max(jnp.abs(src)) + 1.0) * target_pad_val
        tgt_rows = []
        zero_w_rows = []
        for i, t in enumerate(target):
            if _is_empty(t):
                tgt_rows.append(jnp.zeros((m_max, tgt_dim), dtype=dt))
                zero_w_rows.append(i)  # dICP/ICP.py:456,:467
                continue
            t = jnp.asarray(t, dtype=dt)
            if t.ndim != 2 or t.shape[1] != tgt_dim:
                raise ValueError("target list must contain (m x 3/6) tensors with a "
                                 "consistent number of columns")
            mi = t.shape[0]
            if soft_nn:
                pad = pad_val * jnp.ones((m_max - mi, tgt_dim), dtype=dt)
            else:
                pad = jnp.broadcast_to(t[-1:], (m_max - mi, tgt_dim))
            tgt_rows.append(jnp.concatenate([t, pad], axis=0))
        tgt = jnp.stack(tgt_rows)
        if zero_w_rows:
            w = w.at[jnp.array(zero_w_rows)].set(0.0)
    else:
        s = jnp.asarray(source)
        dt = s.dtype
        if keep_source_normals and s.shape[-1] != 6:
            raise ValueError("symmetric ICP requires 6-column sources "
                             "(coordinates + normals); got shape "
                             f"{tuple(s.shape)}")
        if s.ndim == 2 and s.shape[1] in (3, 6):
            src = s[None, :, :src_cols]
        elif s.ndim == 3 and s.shape[2] in (3, 6):
            src = s[:, :, :src_cols]
        else:
            raise ValueError("source must be (n x 3/6) or (N x n x 3/6) or list len(N)")
        if weight is None:
            w = jnp.ones(src.shape[:2], dtype=dt)
        else:
            w = jnp.asarray(weight, dtype=dt)
            if w.ndim == 1:
                w = w[None]

        t = jnp.asarray(target, dtype=dt)
        if t.ndim == 2 and t.shape[1] in (3, 6):
            tgt = t[None]
        elif t.ndim == 3 and t.shape[2] in (3, 6):
            tgt = t
        else:
            raise ValueError("target must be (m x 3/6) or (N x m x 3/6) or list len(N)")
        if tgt.shape[0] != src.shape[0]:
            tgt = jnp.broadcast_to(tgt, (src.shape[0],) + tgt.shape[1:])

    ti = None if T_init is None else _normalize_T(T_init, dt)
    return src, tgt, ti, w


def _normalize_T(T_init, dtype):
    """T_init to (N, 4, 4) (dICP/ICP.py:494-504)."""
    if isinstance(T_init, (list, tuple)):
        return jnp.stack([jnp.asarray(t, dtype=dtype) for t in T_init])
    t = jnp.asarray(T_init, dtype=dtype)
    if t.shape == (4, 4):
        return t[None]
    if t.ndim == 3 and t.shape[1:] == (4, 4):
        return t
    raise ValueError("T_init must be (4 x 4) or (N x 4 x 4) or list len(N) (4 x 4)")


class ICP:
    """Drop-in equivalent of the reference ICP class (dICP/ICP.py:14-44).

    Constructor signature and YAML schema match; ``icp()`` returns the same
    results-dict contract (keys pc/T/costs/deltas/weights/stats,
    dICP/ICP.py:288-303) with JAX arrays, histories sliced to the executed
    iteration count.  Fully differentiable: ``jax.grad`` of any function of
    the returned ``T``/``pc`` w.r.t. the inputs works, including ragged
    list inputs.
    """

    def __init__(self, config_path=None, icp_type="pt2pl", max_iterations=100,
                 tolerance=1e-12, differentiable=True, **solver_kwargs):
        """``solver_kwargs``: :class:`ICPConfig` knobs with no
        reference counterpart (e.g. ``nn_method='cluster'``,
        ``batch_chunk=1024``, ``collect_histories=False``,
        ``cluster_probes=...``) passed through to the solver config."""
        self._base_cfg = config_from_yaml(
            config_path, icp_type=icp_type, max_iterations=max_iterations,
            tolerance=tolerance, differentiable=differentiable).with_(
            **solver_kwargs)
        self.config = load_yaml_config(config_path)  # raw-dict attribute parity
        # Mutable attributes for reference-style attribute pokes
        # (tests/test_ICP_inputs.py:263 sets source_zeroes_are_pad directly).
        self.icp_type = icp_type
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.diff = differentiable
        self.const_iter = self._base_cfg.const_iter
        self.verbose = self._base_cfg.verbose
        self.target_pad_val = self._base_cfg.target_pad_val
        self.source_zeroes_are_pad = self._base_cfg.source_zeroes_are_pad
        self.match_ratio_thresh = self._base_cfg.match_ratio_thresh
        self.use_gumbel = self._base_cfg.use_gumbel
        self.gumbel_eps = self._base_cfg.gumbel_eps
        self.gumbel_tau = self._base_cfg.gumbel_tau
        # Attribute parity: the reference constructor exposes a ``nn`` search
        # object built from the functionality block (dICP/ICP.py:40-44);
        # user code pokes ``icp.nn.tau`` or calls ``icp.nn.find_nn`` directly.
        from dicp_tpu.nn import nn as _nn_cls

        self.nn = _nn_cls(differentiable=differentiable,
                          use_gumbel=self.use_gumbel,
                          eps=self.gumbel_eps, tau=self.gumbel_tau)

    def _call_cfg(self, trim_dist, loss_fn, dim) -> ICPConfig:
        # Reference idiom: user code pokes icp.nn.tau / icp.nn.eps /
        # icp.nn.use_gumbel directly (the reference loop reads self.nn, so
        # the poke changes solve behavior, dICP/ICP.py:44).  Honor it by
        # reading the (possibly mutated) nn shim, falling back to the
        # constructor values.
        nn = getattr(self, "nn", None)
        use_gumbel = getattr(nn, "use_gumbel", self.use_gumbel)
        gumbel_eps = float(getattr(nn, "eps", self.gumbel_eps))
        gumbel_tau = float(getattr(nn, "tau", self.gumbel_tau))
        return self._base_cfg.with_(
            icp_type=self.icp_type,
            max_iterations=self.max_iterations,
            tolerance=self.tolerance,
            differentiable=self.diff,
            const_iter=self.const_iter,
            verbose=self.verbose,
            target_pad_val=float(self.target_pad_val),
            source_zeroes_are_pad=self.source_zeroes_are_pad,
            match_ratio_thresh=self.match_ratio_thresh,
            use_gumbel=use_gumbel,
            gumbel_eps=gumbel_eps,
            gumbel_tau=gumbel_tau,
            dim=dim,
            trim_dist=None if trim_dist is None else float(trim_dist),
            loss_name=None if loss_fn is None else loss_fn["name"],
            loss_metric=1.0 if loss_fn is None else float(loss_fn["metric"]),
        )

    def icp(self, source, target, T_init, weight=None, trim_dist=None,
            loss_fn=None, dim=3, key: Optional[jax.Array] = None):
        return self.dICP(source, target, T_init, weight, trim_dist, loss_fn, dim, key)

    def dICP(self, source, target, T_init, weight=None, trim_dist=None,
             loss_fn=None, dim=3, key: Optional[jax.Array] = None):
        """Main entry point, mirroring ICP.dICP (dICP/ICP.py:49-78).

        ``icp_type='symmetric'`` (no reference counterpart) requires
        6-column sources — the normalizer keeps their normal columns.
        """
        assert dim == 2 or dim == 3, "dim must be 2 or 3"
        cfg = self._call_cfg(trim_dist, loss_fn, dim)
        src, tgt, ti, w = batch_size_handling(
            source, target, T_init, weight, target_pad_val=cfg.target_pad_val,
            keep_source_normals=(self.icp_type == "symmetric"),
            soft_nn=(cfg.differentiable and cfg.use_gumbel))
        if ti is None:
            ti = jnp.broadcast_to(jnp.eye(4, dtype=src.dtype), (src.shape[0], 4, 4))
        elif ti.shape[0] == 1 and src.shape[0] > 1:
            # single (4,4) init shared by the whole batch (reference accepts
            # one T_init for a list batch, dICP/ICP.py:494-504)
            ti = jnp.broadcast_to(ti, (src.shape[0], 4, 4))
        ti = ti.astype(src.dtype)
        result = register_jit(src, tgt, ti, w, cfg=cfg, key=key)
        result = slice_histories(result)
        if self.verbose:
            # iteration count + final step norm (dICP/ICP.py:262-264; the
            # reference norms the whole (N, 6, 1) final-delta stack)
            print(f"ICP converged in {int(jnp.max(result.iterations))} iterations")
            print(f"Final del_T_ts: {float(jnp.linalg.norm(result.deltas[:, -1]))}")
        return _to_results_dict(result)


def _to_results_dict(result: ICPResult) -> dict:
    """Results-dict contract of the reference (dICP/ICP.py:288-303)."""
    return {
        "pc": result.pc,
        "T": result.T,
        "costs": result.costs,
        "deltas": result.deltas,
        "weights": result.weights,
        "stats": {
            "converged": result.converged,
            "iterations": result.iterations,
            "matched_ratio": result.matched_ratio,
        },
    }
