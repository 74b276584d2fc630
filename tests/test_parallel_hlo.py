"""Compiled-HLO collective-count assertions (VERDICT r2 #7).

The scaling claims ("zero data collectives for batch sharding",
"one fused psum per map-sharded GN step") were prose; these tests pin them
against the ACTUAL compiled SPMD programs on the 8-virtual-device mesh, so
a regression that introduces an all-gather or extra all-reduce fails CI.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dicp_tpu.config import ICPConfig
from dicp_tpu.parallel import make_mesh
from dicp_tpu.parallel.sharding import map_sharded_fn
from dicp_tpu.registration import register

CFG = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=25,
                tolerance=1e-10, dim=2, trim_dist=5.0, loss_name="huber",
                loss_metric=1.0, driver="while")


def _collective_counts(txt):
    ops = {}
    for op in ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all"):
        ops[op] = (len(re.findall(rf"= \S+ {op}\(", txt))
                   + len(re.findall(rf"= \S+ {op}-start\(", txt)))
    return ops


def _collective_lines(txt, op):
    return [l for l in txt.splitlines()
            if re.search(rf"= \S+ {op}(-start)?\(", l)]


def test_batch_sharding_no_data_collectives(source_np, target_np):
    """Batch-parallel solve: the ONLY collective is the scalar (pred[])
    all-reduce of the global convergence test — zero data movement."""
    mesh = make_mesh((8, 1))
    shard = NamedSharding(mesh, P("batch"))
    B = 8
    src = jax.device_put(jnp.asarray(np.stack([source_np[:, :3]] * B)), shard)
    tgt = jax.device_put(jnp.asarray(np.stack([target_np] * B)), shard)
    ti = jax.device_put(jnp.asarray(np.stack([np.eye(4)] * B)), shard)
    fn = jax.jit(register, static_argnames=("cfg",), out_shardings=shard)
    txt = fn.lower(src, tgt, ti, None, CFG, None).compile().as_text()

    c = _collective_counts(txt)
    assert c["all-gather"] == 0 and c["reduce-scatter"] == 0 \
        and c["collective-permute"] == 0 and c["all-to-all"] == 0, c
    assert c["all-reduce"] <= 1, c
    for line in _collective_lines(txt, "all-reduce"):
        assert "pred[]" in line, f"non-scalar all-reduce appeared: {line}"


def test_map_sharding_single_fused_psum(source_np, target_np):
    """Map-sharded solve: exactly ONE (variadic) all-reduce — the fused psum
    of the per-shard normal equations (6x6 + 6 + scalars = 45 floats per GN
    step) — and nothing else."""
    mesh = make_mesh((1, 8))
    fn = map_sharded_fn(mesh, CFG, axis="map", target_sharded=False)
    txt = fn.lower(jnp.asarray(source_np[:64, :3]), jnp.ones(64),
                   jnp.asarray(target_np), jnp.eye(4)).compile().as_text()
    c = _collective_counts(txt)
    assert c["all-reduce"] == 1, c
    assert c["all-gather"] == 0 and c["reduce-scatter"] == 0 \
        and c["collective-permute"] == 0 and c["all-to-all"] == 0, c
    # the all-reduce payload must be the small normal-equation block, not a
    # point-sized tensor: no dimension anywhere near the cloud size
    for line in _collective_lines(txt, "all-reduce"):
        for d in re.findall(r"\[(\d+)", line):
            assert int(d) <= 36, f"large all-reduce payload: {line}"


def test_ring_sharding_ppermute_only_for_map_shards(source_np, target_np):
    """Ring-sharded solve: collective-permutes move the target shards around
    the ring; still exactly one psum all-reduce and zero all-gathers (the
    full map is never reassembled on any device)."""
    mesh = make_mesh((1, 8))
    fn = map_sharded_fn(mesh, CFG, axis="map", target_sharded=True)
    txt = fn.lower(jnp.asarray(source_np[:64, :3]), jnp.ones(64),
                   jnp.asarray(target_np[:64]), jnp.eye(4)).compile().as_text()
    c = _collective_counts(txt)
    assert c["all-reduce"] == 1, c
    assert c["collective-permute"] >= 1, c
    assert c["all-gather"] == 0 and c["reduce-scatter"] == 0, c
    # each permute moves one target shard (m/K rows), never the full map
    m_shard = 64 // 8
    for line in _collective_lines(txt, "collective-permute"):
        dims = [int(d) for d in re.findall(r"\[(\d+)", line)]
        assert all(d <= max(m_shard, 6) for d in dims), \
            f"permute payload larger than one shard: {line}"


def test_map_sharding_cluster_no_extra_collectives(source_np, target_np):
    """The cluster correspondence backend inside the map-sharded body is
    pure local compute: per GN ITERATION the compiled program runs exactly
    one fused all-reduce (the normal equations — which with the certificate
    gate also carry the ungated variant + certified count in the SAME
    all-reduce, see sharding._ne).  XLA sinks the loop-invariant scalar
    cost reduction out of the while loop — a once-per-solve collective, so
    at most one extra all-reduce outside the loop is allowed."""
    mesh = make_mesh((1, 8))
    cfg = CFG.with_(nn_method="cluster", cluster_group=16, cluster_probes=8)
    fn = map_sharded_fn(mesh, cfg, axis="map", target_sharded=False)
    txt = fn.lower(jnp.asarray(source_np[:64, :3]), jnp.ones(64),
                   jnp.asarray(target_np), jnp.eye(4)).compile().as_text()
    c = _collective_counts(txt)
    in_loop = [line for line in txt.splitlines()
               if "all-reduce(" in line and "/while/" in line]
    assert len(in_loop) == 1, in_loop
    assert c["all-reduce"] <= 2, c
    assert c["all-gather"] == 0 and c["reduce-scatter"] == 0 \
        and c["collective-permute"] == 0 and c["all-to-all"] == 0, c


def test_map_sharded_ift_backward_constant_collectives(source_np, target_np):
    """IFT backward for the map-sharded solver (VERDICT r2 #2): the grad
    program's collective count exceeds the forward's by a CONSTANT (the k
    (k,k) dG/dxi psums + the target-cotangent psum + bookkeeping), never
    O(iterations) — and introduces no all-gathers."""
    from dicp_tpu.parallel import register_map_sharded_ift
    from dicp_tpu.parallel.sharding import register_map_sharded

    mesh = make_mesh((1, 8))
    cfg = CFG.with_(differentiable=True, driver="auto", max_iterations=25)
    src = jnp.asarray(source_np[:64, :3])
    tgt = jnp.asarray(target_np)

    def loss(s):
        return jnp.sum(register_map_sharded_ift(mesh, s, tgt, cfg=cfg).T)

    def fwd(s):
        return jnp.sum(register_map_sharded_ift(mesh, s, tgt, cfg=cfg).T)

    txt_grad = jax.jit(jax.grad(loss)).lower(src).compile().as_text()
    txt_fwd = jax.jit(fwd).lower(src).compile().as_text()
    cg, cf = _collective_counts(txt_grad), _collective_counts(txt_fwd)
    assert cg["all-gather"] == 0 and cg["reduce-scatter"] == 0 \
        and cg["all-to-all"] == 0, cg
    added = cg["all-reduce"] - cf["all-reduce"]
    # k=3 jvp psums may fuse; target-cotangent psum; small slack for
    # bookkeeping — but nothing iteration-proportional (max_iterations=25)
    assert 0 <= added <= 8, (cg, cf)

    # doubling max_iterations must NOT change the backward's added count
    cfg2 = cfg.with_(max_iterations=50)

    def loss2(s):
        return jnp.sum(register_map_sharded_ift(mesh, s, tgt, cfg=cfg2).T)

    def fwd2(s):
        return jnp.sum(register_map_sharded_ift(mesh, s, tgt, cfg=cfg2).T)

    cg2 = _collective_counts(jax.jit(jax.grad(loss2)).lower(src).compile().as_text())
    cf2 = _collective_counts(jax.jit(fwd2).lower(src).compile().as_text())
    assert cg2["all-reduce"] - cf2["all-reduce"] == added, (cg2, cf2, added)
