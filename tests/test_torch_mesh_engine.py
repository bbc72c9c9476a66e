"""The ``mesh=`` substrate: ``BohmEngine`` over a 4-rank ``cc`` mesh.

Four ranks run as threads over torch's threaded process group on the CPU
(``chip_smoke.thread_ranks``); each rank holds one shard of the version
store (DTensors placed Shard(0)), plans its own records, and the ranks
merge the plan, the metrics and the reads through collectives. The
scenarios are the reference's mesh scripts at their sizes (the store,
spill and paged substrate tests, the engine part of the plan sweep, and
the two service sweeps), each held two ways:

  * against the JAX reference engine (its own ``mesh=`` path does not
    run on this jax): per-batch reads, pinned snapshot reads, read-only
    batches, the ``unshard`` rings where the reference's script compared
    them, and the live-overflow counts — on 4 logical shards and on 1
    shard (store, spill), on 4 logical shards (paged), or the unsharded
    sequential engine the reference's script compared with (the plan
    sweep, the service sweeps);
  * byte for byte against the port's logical ``n_shards=4`` engine (or
    service) on the same stream: every store array (``store_to_numpy``,
    gathered), every ``engine/`` and ``service/`` counter and the host
    stats.

Every rank must return the same results. Beyond the reference's scripts:
the lifecycle auditor and adaptive K on the mesh (against the logical
engine), a mesh whose ``cc`` size is not ``n_shards`` (the store stays
logical), the argument checks, the launch counter under thread ranks,
and the store scenario in 4 real processes over ``gloo``
(``benchmarks_torch.common.spawn_ranks``: a file store in a temporary
directory, a 60 s group timeout).
"""
import types

import numpy as np
import pytest

from _torch_mesh import (OPS, R_STORE, inc_batch, port_batch, port_engine,
                         port_inc, port_state, port_store, store_scenario)
from benchmarks_torch.common import spawn_ranks
from chip_smoke import thread_ranks
from _torch_parity import (assert_dicts_same, assert_same, fresh_ref_engine,
                           inc_workloads, np_)
from repro.core import workloads as ref_wl
from repro.core.txn import make_batch as ref_make_batch
from repro.store import unshard as ref_unshard
from repro_torch.core import workloads as port_wl
from repro_torch.core.engine import BohmEngine
from repro_torch.obs import LifecycleAuditor
from repro_torch.service import TxnService
from repro_torch.store import unshard

def _ycsb_stream(seed, R, T, n, theta=0.9, ops=4, mix="10rmw"):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = port_wl.gen_ycsb_batch(rng, T, R, theta=theta, mix=mix, ops=ops,
                                   device="cpu")
        out.append(tuple(np_(getattr(b, f)) for f in (
            "read_set", "write_set", "txn_type", "args")))
    return out


def _ranks(fn, n=4):
    """``fn(mesh)`` on n thread ranks on the CPU; every rank's result."""
    return thread_ranks(fn, n, device="cpu")


def _ref(arrays):
    return ref_make_batch(*arrays)


def _same_state(a, b, msg):
    assert_dicts_same(a["store"], b["store"], f"{msg}: store")
    assert_dicts_same(a["counters"], b["counters"], f"{msg}: counters")
    for k in ("spill_stats", "storage_stats", "overflow_stats"):
        assert a[k] == b[k], f"{msg}: {k}"
    assert_same(a["k_by_record"], b["k_by_record"], f"{msg}: k_eff")


def _same_out(a, b, msg, keys=None):
    for k in keys or a:
        if k == "state":
            _same_state(a[k], b[k], f"{msg}: {k}")
        elif isinstance(a[k], (list, tuple)) and a[k] and \
                isinstance(a[k][0], np.ndarray):
            assert len(a[k]) == len(b[k]), f"{msg}: {k}"
            for i, (x, y) in enumerate(zip(a[k], b[k])):
                assert_same(x, y, f"{msg}: {k}[{i}]")
        elif isinstance(a[k], np.ndarray):
            assert_same(a[k], b[k], f"{msg}: {k}")
        else:
            assert a[k] == b[k], f"{msg}: {k}: {a[k]} != {b[k]}"


def _mesh_and_logical(scenario, n=4):
    """The scenario on every rank of an n-rank mesh (all ranks equal) and
    on the port's logical n-shard engine; returns (mesh, logical)."""
    ranks = _ranks(lambda mesh: scenario(mesh), n)
    for r, out in enumerate(ranks[1:], 1):
        _same_out(ranks[0], out, f"rank {r} vs rank 0")
    logical = scenario(None)
    _same_out(logical, ranks[0], "mesh vs logical n_shards=4")
    return ranks[0], logical


# ---------------------------------------------------------------------------
# 1. the store scenario (tests/test_store.py, mesh substrate)
# ---------------------------------------------------------------------------
def test_mesh_store_matches_reference_and_logical():
    mesh_out, _ = _mesh_and_logical(port_store)
    assert mesh_out["found_frac"] == 1.0
    for n in (4, 1):
        ref = fresh_ref_engine(R_STORE, "inc3", lambda: inc_workloads(OPS)[0],
                               n_shards=n)
        want = store_scenario(ref, _ref, ref_unshard)
        _same_out(want, mesh_out, f"reference n_shards={n}",
                  keys=list(want))


def test_mesh_store_in_gloo_processes():
    """The store scenario in 4 spawned processes over gloo (one rank a
    process, as on a multi-card machine), equal to the thread ranks'."""
    ranks = spawn_ranks(port_store, 4, "cpu", timeout=60)
    logical = port_store(None)
    for r, out in enumerate(ranks):
        _same_out(logical, out, f"gloo rank {r} vs logical")


# ---------------------------------------------------------------------------
# 2. the spill scenario (tests/test_spill.py, mesh substrate)
# ---------------------------------------------------------------------------
R_SPILL, T_SPILL = 64, 32


def spill_scenario(eng, conv):
    reads, snap = [], None
    for i, arrays in enumerate(_ycsb_stream(13, R_SPILL, T_SPILL, 5)):
        r, _ = eng.run_batch(conv(arrays))
        reads.append(np_(r))
        if i == 0:
            snap = eng.begin_snapshot()
    out = {"reads": reads, "overflow": np_(eng.overflow_by_record())}
    v, f = eng.snapshot_read(np.arange(R_SPILL), snap)
    out.update(snap_vals=np_(v), snap_found=np_(f))
    eng.gc_sweep()
    v, f = eng.snapshot_read(np.arange(R_SPILL), snap)
    out.update(swept_vals=np_(v), swept_found=np_(f))
    return out


def _port_spill(mesh, auditor=False):
    kw = dict(ring_slots=2, spill_buckets=16, spill_slots=16)
    eng = port_engine(R_SPILL, lambda: port_wl.make_ycsb(2, 4), mesh=mesh,
                       n_shards=None if mesh is not None else 4,
                       auditor=LifecycleAuditor() if auditor else None, **kw)
    assert eng.store.versions.spill is not None
    out = spill_scenario(eng, port_batch)
    out["state"] = port_state(eng)
    if auditor:
        aud = eng.auditor
        out["telescope"] = aud.telescope()
        out["gc_report"] = aud.gc_report()
        out["events"] = [tuple(e) if isinstance(e, tuple) else
                         repr(e) for e in aud.events()]
        out["inspect"] = repr(eng.inspect_record(0))
        out["health"] = {k: v for k, v in eng.health().items()
                         if k != "oldest_pin_age_s"}
    return out


def test_mesh_spill_matches_reference_and_logical():
    mesh_out, _ = _mesh_and_logical(_port_spill)
    assert int(mesh_out["overflow"].sum()) > 0
    assert bool(mesh_out["snap_found"].all())
    assert mesh_out["state"]["spill_stats"]["spill_occupancy"] > 0
    assert_same(mesh_out["snap_vals"], mesh_out["swept_vals"], "swept")
    for n, buckets in ((4, 16), (1, 64)):
        ref = fresh_ref_engine(R_SPILL, "ycsb2x4",
                               lambda: ref_wl.make_ycsb(payload_words=2,
                                                        ops=4),
                               n_shards=n, ring_slots=2,
                               spill_buckets=buckets, spill_slots=16)
        want = spill_scenario(ref, _ref)
        _same_out(want, mesh_out, f"reference n_shards={n}",
                  keys=list(want))


def test_mesh_audited_spill_matches_logical():
    """The lifecycle auditor on the mesh: its events, telescope, GC
    report, a record's inspection and the health gauges equal the
    logical engine's (the audit arrays are gathered at each commit)."""
    mesh_out, _ = _mesh_and_logical(lambda m: _port_spill(m, auditor=True))
    assert mesh_out["telescope"]["balanced"]
    assert mesh_out["gc_report"]["pin_stabbed_reclaims"] == 0


# ---------------------------------------------------------------------------
# 3. paged against dense (tests/test_pages.py, mesh substrate), and the
# adaptive-K pass at each sweep
# ---------------------------------------------------------------------------
PAGED = dict(ring_slots=2, paged=True, page_slots=2, pages_per_shard=64,
             spill_buckets=16, spill_slots=16)
DENSE = dict(ring_slots=2, spill_buckets=16, spill_slots=16)
ADAPTIVE = dict(ring_slots=4, adaptive_k=True, k_max=8, paged=True,
                page_slots=2, pages_per_shard=64, spill_buckets=16,
                spill_slots=16)


def _port_paged(mesh, kw):
    eng = port_engine(R_SPILL, lambda: port_wl.make_ycsb(2, 4), mesh=mesh,
                       n_shards=None if mesh is not None else 4, **kw)
    out = spill_scenario(eng, port_batch)
    if eng.adaptive_k:
        # unpinned, three more sweeps with commits between: the policy's
        # hysteresis needs a record idle at two sweeps before it donates
        for handle in list(eng._snapshots.values()):
            eng.release_snapshot(handle)
        for arrays in _ycsb_stream(14, R_SPILL, T_SPILL, 3):
            eng.run_batch(port_batch(arrays))
            eng.gc_sweep()
    out["state"] = port_state(eng)
    return out


@pytest.mark.parametrize("name", ["paged", "adaptive"])
def test_mesh_paged_matches_dense_reference_and_logical(name):
    kw = {"paged": PAGED, "adaptive": ADAPTIVE}[name]
    mesh_out, _ = _mesh_and_logical(lambda m: _port_paged(m, kw))
    assert bool(mesh_out["snap_found"].all())
    if name == "paged":
        dense = _ranks(lambda m: _port_paged(m, DENSE), 4)[0]
        _same_out(dense, mesh_out, "paged mesh vs dense mesh",
                  keys=["reads", "snap_vals", "snap_found", "swept_vals",
                        "swept_found"])
        ref = fresh_ref_engine(R_SPILL, "ycsb2x4",
                               lambda: ref_wl.make_ycsb(payload_words=2,
                                                        ops=4),
                               n_shards=4, **kw)
        want = spill_scenario(ref, _ref)
        _same_out(want, mesh_out, "reference n_shards=4", keys=list(want))
    else:
        assert mesh_out["state"]["counters"]["engine/k_slots_granted"] > 0


# ---------------------------------------------------------------------------
# 4. the engine part of the plan sweep (tests/test_plan.py)
# ---------------------------------------------------------------------------
R_PLAN = 32


def plan_engine_scenario(eng, conv, seed):
    reads = []
    for i in range(2):
        r, _ = eng.run_batch(conv(inc_batch(100 + seed * 10 + i, R_PLAN)))
        reads.append(np_(r))
    v, f = eng.snapshot_read(np.arange(R_PLAN))
    return {"reads": reads, "head": np_(eng.snapshot()), "vals": np_(v),
            "found": np_(f)}


def test_mesh_plan_sweep_engine_matches_unsharded():
    def port(mesh):
        outs = []
        for seed in range(3):
            eng = port_engine(R_PLAN, port_inc,
                               mesh=mesh,
                               n_shards=None if mesh is not None else 4)
            out = plan_engine_scenario(eng, port_batch, seed)
            out["state"] = port_state(eng)
            outs.append(out)
        return {"seeds": outs}

    ranks = _ranks(port, 4)
    logical = port(None)
    for r, got in enumerate(ranks):
        for seed, (a, b) in enumerate(zip(logical["seeds"], got["seeds"])):
            _same_out(a, b, f"rank {r} seed {seed} vs logical")
    for seed, got in enumerate(ranks[0]["seeds"]):
        ref = fresh_ref_engine(R_PLAN, "inc3",
                               lambda: inc_workloads(OPS)[0])
        want = plan_engine_scenario(ref, _ref, seed)
        _same_out(want, got, f"seed {seed} vs reference", keys=list(want))


def test_mesh_of_another_size_keeps_the_store_logical():
    """A 4-rank mesh with n_shards=2: the store stays logical (the
    reference's rule), the plan is still sharded over the mesh, and the
    reads equal the logical 2-shard engine's."""
    def port(mesh):
        eng = port_engine(R_PLAN, port_inc,
                           mesh=mesh, n_shards=2)
        out = plan_engine_scenario(eng, port_batch, 0)
        out["state"] = port_state(eng)
        out["dtensor"] = type(eng.store.versions.k_eff).__name__
        return out

    got = _ranks(port, 4)[0]
    want = port(None)
    assert got.pop("dtensor") == want.pop("dtensor") == "Tensor"
    _same_out(want, got, "mesh (n_shards=2) vs logical")


def test_launch_counts_under_thread_ranks():
    """Thread ranks on one card share ``_build.LAUNCHES``: with a switch
    interval of a microsecond, 16 threads x 2,000 counts lose none, and
    each thread reads its own."""
    import sys
    import threading

    from repro_torch.kernels import _build
    before = _build.LAUNCHES["mvcc_resolve"]
    mine = [None] * 16

    def work(i):
        for _ in range(2000):
            _build.count("mvcc_resolve", "mvcc_resolve/rows")
        mine[i] = dict(_build.thread_launches())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["mvcc_resolve"] - before == 16 * 2000
    assert all(m == {"mvcc_resolve": 2000, "mvcc_resolve/rows": 2000}
               for m in mine)
    _build.reset_launches()


def test_mesh_argument_checks():
    """``mesh=`` must be a DeviceMesh whose device type is the engine's."""
    wl = port_wl.make_ycsb(2, 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        BohmEngine(16, wl, device="cpu", mesh=object())
    fake = types.SimpleNamespace(mesh_dim_names=("cc",), device_type="cuda",
                                 size=lambda dim=None: 4)
    with pytest.raises(ValueError, match="cuda"):
        BohmEngine(16, wl, device="cpu", mesh=fake)


# ---------------------------------------------------------------------------
# 5. the service sweeps (tests/test_service.py): pipelined, and
# conflict-aware with merged and deferred epochs
# ---------------------------------------------------------------------------
def _striped(seed, n=6, R=64, T=16):
    rng = np.random.default_rng(seed)
    out = []
    for stripe in range(n):
        lo = 16 * (stripe % 4)
        reads = rng.integers(lo, lo + 16, (T, OPS))
        writes = np.where(rng.random((T, OPS)) < 0.6, reads, -1)
        out.append(tuple(np.asarray(a, np.int32) for a in (
            reads, writes, rng.integers(0, 2, T),
            rng.integers(1, 5, (T, 1)))))
    return out


def service_scenario(eng, batches, **kw):
    svc = TxnService(eng, **kw)
    tickets, snap = [], None
    for i, b in enumerate(batches):
        tickets.append(svc.submit(port_batch(b)))
        if i == 1:
            snap = svc.begin_snapshot()
    reads = [np_(svc.wait(t).read_vals) for t in tickets]
    svc.drain()
    v, f = eng.snapshot_read(np.arange(eng.num_records), snap)
    out = {"reads": reads, "head": np_(eng.snapshot()), "snap_ts": snap.ts,
           "snap_vals": np_(v), "snap_found": np_(f),
           "merged": int(dict(svc.stats).get("merged_batches", 0))}
    return out


def _sequential(eng, conv, batches):
    reads, snap = [], None
    for i, b in enumerate(batches):
        r, _ = eng.run_batch(conv(b))
        reads.append(np_(r))
        if i == 1:
            snap = eng.begin_snapshot()
    v, f = eng.snapshot_read(np.arange(eng.num_records), snap)
    return {"reads": reads, "head": np_(eng.snapshot()), "snap_ts": snap.ts,
            "snap_vals": np_(v), "snap_found": np_(f)}


SERVICE = {
    "pipelined": [(seed0, "inc", 32, [inc_batch(seed0 + i, 32)
                                       for i in range(5)],
                   dict(max_inflight=2)) for seed0 in (0, 50)],
    "conflict_aware": [
        (0, "inc", 64, _striped(0), dict(max_inflight=2,
                                         admission_window=3)),
        (50, "ycsb", 64, _ycsb_stream(50, 64, 16, 6, theta=0.6, ops=10),
         dict(max_inflight=2, admission_window=3))],
}
WL = {"inc": (lambda: inc_workloads(OPS)[0], port_inc),
      "ycsb": (ref_wl.make_ycsb, port_wl.make_ycsb)}


@pytest.mark.parametrize("mode", ["pipelined", "conflict_aware"])
def test_mesh_service_matches_sequential_reference_and_logical(mode):
    cases = SERVICE[mode]

    def port(mesh):
        outs = []
        for _, wl, R, batches, kw in cases:
            eng = port_engine(R, WL[wl][1], mesh=mesh, ring_slots=8,
                               n_shards=None if mesh is not None else 4)
            out = service_scenario(eng, batches, **kw)
            eng.gc_sweep()
            out["state"] = port_state(eng)
            g = unshard(eng.store.versions)
            out.update({f"ring_{f}": np_(getattr(g, f))
                        for f in ("begin", "end", "payload", "head")})
            outs.append(out)
        return {"cases": outs}

    ranks = _ranks(port, 4)
    logical = port(None)
    for r, got in enumerate(ranks):
        for i, (a, b) in enumerate(zip(logical["cases"], got["cases"])):
            _same_out(a, b, f"{mode} case {i} rank {r} vs logical")
    for (seed0, wl, R, batches, kw), got in zip(cases, ranks[0]["cases"]):
        if wl == "inc" and mode == "conflict_aware":
            assert got["merged"] > 0
        ref = fresh_ref_engine(R, f"{wl}-svc", WL[wl][0], ring_slots=8)
        want = _sequential(ref, _ref, batches)
        _same_out(want, got, f"{mode} seed {seed0} vs sequential reference",
                  keys=list(want))
        if mode == "conflict_aware":
            ref.gc_sweep()
            g = ref_unshard(ref.store.versions)
            for f in ("begin", "end", "payload", "head"):
                assert_same(getattr(g, f), got[f"ring_{f}"],
                            f"{mode} seed {seed0}: ring {f} after sweep")

