"""Record-partitioned CC (paper §4.1.2): ``cc_plan_sharded`` and
``merge_sharded_plan`` against the JAX reference.

The reference's own ``cc_plan_sharded`` needs a ``cc`` mesh whose merge
does not run on this jax, so the oracle is its shard body (``cc_plan``
of the batch masked to the records a shard owns, ``repro/core/plan.py``)
run for every shard, stacked, then its ``merge_sharded_plan``. A seeded
sweep (R in {33, 64}, T = 16, 3 ops, n in {2, 4}, six batches each)
holds, byte for byte in all twelve ``Plan`` fields, the port's logical
form (the [n, ...] plan on one device), its mesh form (n ranks as
threads, each planning its shard, gathered) and both merges to the
reference's. The merged plan also agrees with the port's unsharded
``cc_plan`` as ``tests/test_plan.py`` checks it: the same read
dependencies and the same set of version rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import thread_ranks
from _torch_parity import assert_same, np_
from repro.core import plan as ref_plan
from repro.core.txn import TxnBatch as RefBatch
from repro.core.txn import make_batch as ref_make_batch
from repro_torch.core.plan import (Plan, cc_plan, cc_plan_sharded,
                                   merge_sharded_plan)
from repro_torch.core.txn import make_batch
from repro_torch.store import full

T, OPS, SEEDS = 16, 3, 6
FIELDS = [f.name for f in dataclasses.fields(Plan)]


def _ranks(fn, n=4):
    """``fn(mesh)`` on n thread ranks on the CPU; every rank's result."""
    return thread_ranks(fn, n, device="cpu")


def _arrays(seed, R):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, R, (T, OPS))
    writes = np.where(rng.random((T, OPS)) < 0.6, reads, -1)
    return tuple(np.asarray(a, np.int32) for a in (
        reads, writes, rng.integers(0, 2, T), rng.integers(1, 5, (T, 1))))


def _ts(seed):
    return 1 + 17 * seed


@jax.jit
def _ref_shard(read_set, write_set, txn_type, args, ts_base, n, shard):
    """The reference's shard body (plan.py, ``cc_plan_sharded``)."""
    owned_w = (write_set % n) == shard
    owned_r = (read_set % n) == shard
    local = RefBatch(jnp.where(owned_r & (read_set >= 0), read_set, -1),
                     jnp.where(owned_w & (write_set >= 0), write_set, -1),
                     txn_type, args)
    return ref_plan.cc_plan(local, ts_base)


_ref_merge = jax.jit(ref_plan.merge_sharded_plan)


def _reference(arrays, ts, n):
    batch = ref_make_batch(*arrays)
    parts = [_ref_shard(*arrays, jnp.int32(ts), n, s) for s in range(n)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *parts)
    return stacked, _ref_merge(stacked, batch)


def _assert_plan(ref, port, msg):
    for f in FIELDS:
        assert_same(getattr(ref, f), full(getattr(port, f)), f"{msg}: {f}")


def _version_rows(p):
    v = np_(p.w_valid).astype(bool)
    rows = np.stack([np_(p.w_rec)[v], np_(p.w_txn)[v],
                     np_(p.w_end_local)[v],
                     np_(p.commit_mask)[v].astype(np.int32),
                     np_(p.w_begin_ts)[v], np_(p.w_end_ts)[v]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("R", [33, 64])
def test_sharded_plan_matches_reference(R, n):
    def on_mesh(mesh):
        out = []
        for seed in range(SEEDS):
            batch = make_batch(*_arrays(seed, R), device="cpu")
            sharded = cc_plan_sharded(batch, _ts(seed), mesh)
            whole = Plan(*(full(getattr(sharded, f)) for f in FIELDS))
            out.append((whole, merge_sharded_plan(sharded, batch)))
        return out

    ranks = _ranks(on_mesh, n)
    for seed in range(SEEDS):
        arrays = _arrays(seed, R)
        ref_stacked, ref_merged = _reference(arrays, _ts(seed), n)
        batch = make_batch(*arrays, device="cpu")
        logical = cc_plan_sharded(batch, _ts(seed), n_shards=n)
        msg = f"R={R} n={n} seed={seed}"
        _assert_plan(ref_stacked, logical, f"{msg} logical plan")
        _assert_plan(ref_merged, merge_sharded_plan(logical, batch),
                     f"{msg} logical merge")
        for r, per_seed in enumerate(ranks):
            whole, merged = per_seed[seed]
            _assert_plan(ref_stacked, whole, f"{msg} rank {r} plan")
            _assert_plan(ref_merged, merged, f"{msg} rank {r} merge")
        # the merge resolves as the unsharded planner does
        one = cc_plan(batch, torch.tensor(_ts(seed), dtype=torch.int32))
        merged = ranks[0][seed][1]
        assert_same(one.r_dep_txn, merged.r_dep_txn, f"{msg} r_dep_txn")
        np.testing.assert_array_equal(_version_rows(one),
                                      _version_rows(merged), msg)


# ---------------------------------------------------------------------------
# The benchmarks' mesh rows, rehearsed on the CPU over thread ranks
# ---------------------------------------------------------------------------
def _launch(fn, n, device):
    return thread_ranks(fn, n, device=device)


def test_microbench_mesh_columns_rehearsal(monkeypatch, tmp_path):
    """Fig 4's ``cc_shards`` 2 and 4 columns through the mesh-row code
    (``points`` on an n-rank mesh) at a tiny size: the columns the cards
    allow, in order, each point's waves those of a logical engine on the
    same seeded batch."""
    from benchmarks_torch import common, microbench
    from repro_torch.core.engine import BohmEngine
    from repro_torch.core.workloads import gen_ycsb_batch, make_microbench
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(microbench, "N_RECORDS", 4096)
    sizes = (32, 64)
    rows = microbench.run(cc_shards=(1, 2, 4, 8), batch_sizes=sizes,
                          device="cpu", cards=4, launch=_launch)
    assert [(r["cc_shards"], r["batch"]) for r in rows] == \
        [(n, b) for n in (1, 2, 4) for b in sizes]
    rng = np.random.default_rng(3)
    for r in rows:
        batch = gen_ycsb_batch(rng, r["batch"], 4096, theta=0.0,
                               mix="10rmw", device="cpu")
        eng = BohmEngine(4096, make_microbench(), device="cpu")
        _, m = eng.run_batch(batch)
        assert r["waves"] == int(m["waves"]) and r["txn_s"] > 0, r


def test_pipeline_mesh_rows_rehearsal(monkeypatch, tmp_path):
    """The Fig 3 pipeline with ``substrate: "mesh"`` rows for 2 and 4
    shards (cards=4, thread ranks): every field but the wall times equals
    the logical rows of the same seeded stream (which
    ``test_torch_bench_service.py`` holds to the reference's)."""
    from benchmarks_torch import common, pipeline
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(pipeline, "N_RECORDS", 256)
    monkeypatch.setattr(pipeline, "BATCH", 16)
    logical = pipeline.run(quick=True, device="cpu")
    rows = pipeline.run(quick=True, device="cpu", cards=4, launch=_launch)
    assert [r["substrate"] for r in logical] == ["logical"] * 9
    assert [r["substrate"] for r in rows] == ["logical"] * 3 + ["mesh"] * 6
    bad = common.row_mismatches(
        logical, [dict(r, substrate="logical") for r in rows])
    assert not bad, bad
