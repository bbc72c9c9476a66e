"""TxnService parity: the port's scheduler (``repro_torch.service``,
``device="cpu"``) against the JAX reference's ``repro.service.TxnService``
on the same streams — the in-process cases of ``tests/test_service.py``
and ``tests/test_scheduler_props.py``.

For every stream both services get the same calls (submit or
submit_many, latency classes, a pin mid-window, wait, drain) and must
give byte-equal per-ticket ``read_vals``, the same ``dispatch_log``, the
same ``service/*`` and ``engine/*`` counters, byte-equal reads at the
pinned snapshot (``snapshot_read`` and a read-only scan batch) and
byte-equal final store arrays. Modes: FIFO pipelined and barriered,
``reorder=False`` windows 2-4, out-of-order with exec chaining, latency
classes, hop budgets, 1 and 2 logical shards. The hypothesis fuzz holds
the port to its own sequential engine in ``dispatch_log`` order (no
reference, no jit). Shapes are small (R=64, batches of 16 x 3 ops) and
the reference engines come from the shared cache, so each jitted phase
compiles once per epoch shape and process.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (BATCH_FIELDS, assert_dicts_same, assert_same,
                           fresh_ref_engine, inc_workloads, np_,
                           ref_store_arrays)
from repro.core import workloads as ref_wl
from repro.core.txn import make_batch as ref_make_batch
from repro.service import TxnService as RefService
from repro_torch.core import workloads as port_wl
from repro_torch.core.carry import store_to_numpy
from repro_torch.core.engine import BohmEngine
from repro_torch.core.txn import make_batch
from repro_torch.service import TxnService

R, T, OPS, RING = 64, 16, 3, 8
# the reorder streams keep test_scheduler_props.py's shape: R=128,
# batches of 8 x 2 ops, 8 key stripes of 16 records
R_P, T_P, OPS_P, N_STRIPES = 128, 8, 2, 8

WORKLOADS = {
    "inc": (lambda: inc_workloads(OPS)[0], lambda: inc_workloads(OPS)[1]),
    "inc2": (lambda: inc_workloads(OPS_P)[0],
             lambda: inc_workloads(OPS_P)[1]),
    "ycsb": (ref_wl.make_ycsb, port_wl.make_ycsb),
    "smallbank": (ref_wl.make_smallbank, port_wl.make_smallbank),
}
RECORDS = {"inc2": R_P}     # every other workload runs at R


# ---------------------------------------------------------------------------
# streams: lists of numpy (read_set, write_set, txn_type, args)
# ---------------------------------------------------------------------------
def _arrays(reads, writes, types, args):
    return tuple(np.asarray(a, np.int32) for a in (reads, writes, types,
                                                   args))


def _random(rng, lo=0, hi=R, t=T, wprob=0.6, ops=OPS):
    reads = rng.integers(lo, hi, (t, ops))
    writes = np.where(rng.random((t, ops)) < wprob, reads, -1)
    return _arrays(reads, writes, rng.integers(0, 2, t),
                   rng.integers(1, 5, (t, 1)))


def _stripe(rng, stripe):
    """An RMW batch confined to one of N_STRIPES disjoint key ranges —
    batches of different stripes commute, same-stripe batches conflict."""
    w = R_P // N_STRIPES
    return _random(rng, stripe * w, (stripe + 1) * w, t=T_P, wprob=0.8,
                   ops=OPS_P)


def _of(batch):
    return tuple(np.array(np_(getattr(batch, f))) for f in BATCH_FIELDS)


def _stream(kind, seed, n):
    """(workload name, arrays) of one seeded stream."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return "inc", [_random(rng) for _ in range(n)]
    if kind == "striped":          # 4 disjoint stripes of 16, round robin
        return "inc", [_random(rng, 16 * (i % 4), 16 * (i % 4) + 16)
                       for i in range(n)]
    if kind == "ycsb_uniform":
        return "ycsb", [_of(ref_wl.gen_ycsb_batch(rng, T, R, theta=0.0,
                                                  mix="10rmw"))
                        for _ in range(n)]
    if kind == "ycsb_zipf":
        return "ycsb", [_of(ref_wl.gen_ycsb_batch(rng, T, R, theta=0.9,
                                                  mix="2rmw8r"))
                        for _ in range(n)]
    if kind == "smallbank":
        return "smallbank", [_of(ref_wl.gen_smallbank_batch(rng, T, R // 2))
                             for _ in range(n)]
    raise ValueError(kind)


def _reorder_stream(rng, n):
    """Hop-provoking shape (``test_scheduler_props._gen_stream``):
    same-stripe bursts interleaved with fresh-stripe traffic and
    occasional interactive batches."""
    batches, classes, stripe = [], [], 0
    for _ in range(n):
        if rng.random() < 0.35:
            s = 0                     # the contended stripe
        else:
            stripe = (stripe + 1) % N_STRIPES
            s = stripe
        batches.append(_stripe(rng, s))
        classes.append("interactive" if rng.random() < 0.2 else "bulk")
    return batches, classes


def _scan(wl):
    """The read-only scan batch read at the pin."""
    ops = OPS_P if wl == "inc2" else OPS
    return _of(ref_wl.gen_scan_batch(np.random.default_rng(2), 8,
                                     RECORDS.get(wl, R), ops=ops))


# ---------------------------------------------------------------------------
# one run per side, then the comparison
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Run:
    svc: object
    reads: list
    snap: object = None
    pin_epochs: int = None
    pinned: tuple = ()
    store: dict = None


def _ref_engine(wl, n_shards):
    return fresh_ref_engine(RECORDS.get(wl, R), wl, WORKLOADS[wl][0],
                            ring_slots=RING, n_shards=n_shards)


def _port_engine(wl, n_shards):
    return BohmEngine(RECORDS.get(wl, R), WORKLOADS[wl][1](),
                      ring_slots=RING, n_shards=n_shards, device="cpu")


def _drive(side, wl, stream, classes=None, pin_at=None, burst=False,
           n_shards=1, flight=None, **svc_kw):
    """One service run of ``stream`` on ``side`` ("ref" or "port"): the
    reference's call sequence of ``test_service.py``."""
    if side == "ref":
        eng, cls = _ref_engine(wl, n_shards), RefService
        mk = ref_make_batch
    else:
        eng, cls = _port_engine(wl, n_shards), TxnService
        mk = lambda *a: make_batch(*a, device="cpu")      # noqa: E731
    svc = cls(eng, flight=flight, **svc_kw)
    batches = [mk(*a) for a in stream]
    run = _Run(svc, [])
    if burst:
        tickets = svc.submit_many(batches)
    else:
        tickets = []
        for i, b in enumerate(batches):
            tickets.append(svc.submit(
                b, latency_class=classes[i] if classes else "bulk"))
            if i == pin_at:
                run.snap = svc.begin_snapshot()
                run.pin_epochs = len(svc.dispatch_log)
    run.reads = [np_(svc.wait(t).read_vals) for t in tickets]
    svc.drain()
    if run.snap is not None:
        v, f = eng.snapshot_read(np.arange(eng.num_records), run.snap)
        s, g, _ = svc.run_readonly_batch(mk(*_scan(wl)), run.snap)
        run.pinned = tuple(np_(x) for x in (v, f, s, g))
    run.store = (ref_store_arrays if side == "ref" else store_to_numpy)(
        eng.store)
    return run


def _counters(svc):
    snap = svc.metrics.snapshot(include_gauges=False)
    return {k: v for k, v in snap.items()
            if k.startswith(("service/", "engine/"))}


def _assert_same_runs(ref, port, msg=""):
    assert len(ref.reads) == len(port.reads)
    for i, (a, b) in enumerate(zip(ref.reads, port.reads)):
        assert_same(a, b, f"{msg}: ticket {i} read_vals")
    assert port.svc.dispatch_log == ref.svc.dispatch_log, msg
    assert dict(port.svc.stats) == dict(ref.svc.stats), msg
    assert_dicts_same(_counters(ref.svc), _counters(port.svc),
                      f"{msg}: counters")
    assert (ref.snap is None) == (port.snap is None)
    if ref.snap is not None:
        assert ref.snap.ts == port.snap.ts and \
            ref.pin_epochs == port.pin_epochs, msg
        for name, a, b in zip(("snap vals", "snap found", "scan vals",
                               "scan found"), ref.pinned, port.pinned):
            assert_same(a, b, f"{msg}: {name}")
    assert_dicts_same(ref.store, port.store, f"{msg}: store")
    assert port.svc.engine.current_ts() == ref.svc.engine.current_ts()


def _both(wl, stream, **kw):
    ref = _drive("ref", wl, stream, **kw)
    port = _drive("port", wl, stream, **kw)
    _assert_same_runs(ref, port, str(kw))
    return ref, port


# ---------------------------------------------------------------------------
# 1. FIFO pipelined / barriered, a snapshot pinned mid-pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("pipelined", [True, False])
def test_service_equals_reference(n_shards, pipelined):
    for seed in (0, 100):
        wl, stream = _stream("random", seed, 6)
        _, port = _both(wl, stream, pin_at=1, n_shards=n_shards,
                        max_inflight=2, pipelined=pipelined)
        # and the port's own sequential engine, in submission order
        eng = _port_engine(wl, n_shards)
        for i, a in enumerate(stream):
            r, _ = eng.run_batch(make_batch(*a, device="cpu"))
            assert_same(r, port.reads[i], f"sequential batch {i}")
        assert int(port.pinned[1].sum()) > R // 2


def test_burst_submit_plans_ahead():
    """submit_many fills the CC plan window to max_inflight before the
    first exec join."""
    wl, stream = _stream("random", 0, 6)
    _, port = _both(wl, stream, burst=True, max_inflight=2)
    assert port.svc.stats["planned_ahead_max"] == 2


# ---------------------------------------------------------------------------
# 2. ticket semantics and the timestamp mirror
# ---------------------------------------------------------------------------
def test_poll_wait_semantics():
    _, stream = _stream("random", 0, 2)
    svc = TxnService(_port_engine("inc", 1), max_inflight=2)
    t0 = svc.submit(make_batch(*stream[0], device="cpu"))
    t1 = svc.submit(make_batch(*stream[1], device="cpu"))
    assert t1 == t0 + 1
    r1 = svc.wait(t1)
    assert r1.ticket == t1 and tuple(r1.read_vals.shape) == (T, OPS, 2)
    r0 = svc.poll(t0)            # ready at once on the CPU
    assert r0 is not None and r0.ticket == t0
    assert svc.poll(t0) is None  # retrieval consumes the ticket
    with pytest.raises(KeyError):
        svc.wait(99)
    svc.drain()
    assert svc.stats["submitted"] == 2


def test_service_timestamp_mirror_matches_engine():
    """After submit returns, the engine's snapshot clock covers the
    submitted batch, on both sides alike."""
    _, stream = _stream("random", 0, 2)
    ref_eng, port_eng = _ref_engine("inc", 1), _port_engine("inc", 1)
    ref, port = RefService(ref_eng), TxnService(port_eng)
    for k, a in enumerate(stream, start=1):
        ref.submit(ref_make_batch(*a))
        port.submit(make_batch(*a, device="cpu"))
        assert port_eng.current_ts() == ref_eng.current_ts() == k * T
    ref.drain()
    port.drain()
    v, f = port_eng.snapshot_read(np.arange(R))
    assert bool(f.all())
    assert torch.equal(v, port_eng.snapshot())
    assert_same(ref_eng.snapshot_read(np.arange(R))[0], v)


# ---------------------------------------------------------------------------
# 3. conflict-aware admission (window 3): merged epochs + exec overlap,
#    a pin landed while batches are held in the admission queue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ycsb_uniform", "ycsb_zipf", "smallbank",
                                  "striped"])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_conflict_aware_equals_reference(kind, n_shards):
    for seed in (0, 7):
        wl, stream = _stream(kind, seed, 7)
        _both(wl, stream, pin_at=1, n_shards=n_shards, max_inflight=2,
              admission_window=3)


def test_conflict_aware_merges_and_overlaps_on_disjoint_stream():
    """Window 4 merges a striped stream, window 2 overlaps its execs, a
    fully conflicting hot stream does neither — on both sides alike."""
    wl, stream = _stream("striped", 3, 8)
    _, p4 = _both(wl, stream, burst=True, max_inflight=2,
                  admission_window=4)
    assert p4.svc.stats["merged_batches"] > 0
    assert p4.svc.stats["admission_window_occupancy"] == 4
    _, p2 = _both(wl, stream, burst=True, max_inflight=2,
                  admission_window=2, reorder=False)
    assert p2.svc.stats["overlapped_execs"] > 0
    hot = [_arrays(np.zeros((T, OPS)), np.zeros((T, OPS)), np.zeros(T),
                   np.ones((T, 1))) for _ in range(4)]
    _, ph = _both("inc", hot, burst=True, max_inflight=2,
                  admission_window=4)
    assert ph.svc.stats["merged_batches"] == 0
    assert ph.svc.stats["overlapped_execs"] == 0


def test_burst_conflict_aware_fifo_window():
    """submit_many through a FIFO-prefix window of 3: merged epochs hand
    each ticket its own read slice."""
    wl, stream = _stream("striped", 11, 6)
    _, port = _both(wl, stream, burst=True, max_inflight=2,
                    admission_window=3, reorder=False)
    assert port.svc.stats["merged_batches"] > 0
    assert all(r.shape == (T, OPS, 2) for r in port.reads)


# ---------------------------------------------------------------------------
# 4. out-of-order admission: hops, chains, latency classes, hop budgets
# ---------------------------------------------------------------------------
OOO_CASES = [
    (3, dict(max_inflight=4, admission_window=8, max_inflight_execs=4)),
    (11, dict(max_inflight=3, admission_window=6, max_inflight_execs=3,
              max_hops=2)),
    (23, dict(max_inflight=2, admission_window=4, max_inflight_execs=2,
              max_hops=1)),
]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_reordered_schedule_equals_reference(n_shards):
    """The seeded sweep of ``test_scheduler_props.py`` (2 shards: its
    first case), a pin mid-window, latency classes on."""
    hopped = 0
    for seed, kw in OOO_CASES[:3 if n_shards == 1 else 1]:
        batches, classes = _reorder_stream(np.random.default_rng(seed), 10)
        _, port = _both("inc2", batches, classes=classes, pin_at=4,
                        n_shards=n_shards, **kw)
        flat = sorted(t for ep in port.svc.dispatch_log for t in ep)
        assert flat == list(range(len(batches)))
        hopped += port.svc.stats["hopped_batches"]
    assert hopped > 0      # the sweep exercises reordering


def test_starvation_bound():
    """After max_hops jumps a conflicting batch becomes a barrier; every
    blocker is dispatched within a bounded number of formations."""
    rng = np.random.default_rng(5)
    stream = [_stripe(rng, 0) for _ in range(4)] + \
        [_stripe(rng, 1 + (k % (N_STRIPES - 1))) for k in range(10)]

    def run(max_hops):
        return _both("inc2", stream, burst=True, max_inflight=4,
                     admission_window=6, max_inflight_execs=4,
                     max_hops=max_hops)[1].svc

    def epoch_of(svc, t):
        return next(i for i, ep in enumerate(svc.dispatch_log) if t in ep)

    tight, loose = run(1), run(8)
    assert loose.stats["hopped_batches"] > 0
    for svc in (tight, loose):
        for i in range(4):
            assert epoch_of(svc, i) <= i + 1
    assert epoch_of(loose, 6) < epoch_of(loose, 3)
    assert epoch_of(tight, 6) >= epoch_of(tight, 3)
    assert loose.stats["hopped_batches"] > tight.stats["hopped_batches"]


def test_interactive_jumps_bulk():
    rng = np.random.default_rng(9)
    stream = [_stripe(rng, 0) for _ in range(3)] + [_stripe(rng, 1)]
    classes = ["bulk"] * 3 + ["interactive"]
    _, port = _both("inc2", stream, classes=classes, max_inflight=4,
                    admission_window=8, max_inflight_execs=4)
    assert port.svc.stats["class_promotions"] >= 1
    flat = [t for ep in port.svc.dispatch_log for t in ep]
    assert flat.index(3) < max(flat.index(t) for t in range(3))


def test_fifo_mode_never_hops():
    batches, classes = _reorder_stream(np.random.default_rng(13), 8)
    _, port = _both("inc2", batches, max_inflight=2, admission_window=4,
                    reorder=False)
    assert port.svc.stats["hopped_batches"] == 0
    flat = [t for ep in port.svc.dispatch_log for t in ep]
    assert flat == sorted(flat)


# ---------------------------------------------------------------------------
# 5. deferred commits: exec chains read the store their plan saw
# ---------------------------------------------------------------------------
def test_commit_is_functional_under_exec_chaining():
    """A chained exec runs against ``engine.store`` before the earlier
    commits land; that is sound only while a commit builds new tensors
    and leaves its input store as it was. Hold ``_commit`` to that, then
    run a chained stream against the reference."""
    wl, stream = _stream("striped", 5, 8)
    eng = _port_engine(wl, 1)
    batch = make_batch(*stream[0], device="cpu")
    store = eng.store
    before = store_to_numpy(store)
    plan = eng._plan(batch, store.ts_counter)
    w_data, _, _ = eng._exec(plan, batch, store)
    new, _ = eng._commit(plan, batch, store, w_data,
                         torch.tensor(1, dtype=torch.int32), None,
                         eng.pin_array())
    assert_dicts_same(before, store_to_numpy(store), "input store")
    assert not np.array_equal(store_to_numpy(new)["base"], before["base"])
    # pairs of stripes per epoch, every epoch disjoint from the others:
    # the execs chain four deep before the first commit lands
    rng = np.random.default_rng(5)
    chained = [_stripe(rng, i % N_STRIPES) for i in range(8)]
    _, port = _both("inc2", chained, burst=True, max_inflight=4,
                    admission_window=2, max_inflight_execs=4)
    assert port.svc.stats["chain_depth_max"] == 4


# ---------------------------------------------------------------------------
# 6. hypothesis fuzz against the port's own sequential engine
# ---------------------------------------------------------------------------
def _port_sequential(batches, order, pin_after_epochs=None,
                     dispatch_log=None):
    eng = _port_engine("inc2", 1)
    reads, snap, done = {}, None, 0
    if pin_after_epochs == 0:
        snap = eng.begin_snapshot()
    for i in order:
        reads[i] = np_(eng.run_batch(make_batch(*batches[i],
                                                device="cpu"))[0])
        done += 1
        if dispatch_log is not None and pin_after_epochs is not None \
                and snap is None:
            if done == sum(len(ep) for ep in
                           dispatch_log[:pin_after_epochs]):
                snap = eng.begin_snapshot()
    return eng, reads, snap


def test_reordered_schedule_byte_identical_fuzz():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(0, 2**16), n=st.integers(4, 12),
           window=st.integers(2, 8), max_inflight=st.integers(1, 4),
           max_execs=st.integers(1, 4), max_hops=st.integers(1, 6),
           pin_at=st.integers(0, 3))
    def run(seed, n, window, max_inflight, max_execs, max_hops, pin_at):
        batches, classes = _reorder_stream(np.random.default_rng(seed), n)
        got = _drive("port", "inc2", batches, classes=classes,
                     pin_at=min(pin_at, n - 1), max_inflight=max_inflight,
                     admission_window=window, max_inflight_execs=max_execs,
                     max_hops=max_hops)
        log = got.svc.dispatch_log
        flat = [t for ep in log for t in ep]
        assert sorted(flat) == list(range(n))
        # submission order: per-ticket reads and the head store
        seq, reads, _ = _port_sequential(batches, range(n))
        for i in range(n):
            assert_same(reads[i], got.reads[i], f"ticket {i}")
        assert_same(seq.snapshot(), got.store["base"], "head store")
        # dispatch order: the whole store and the pinned snapshot
        dseq, dreads, dsnap = _port_sequential(batches, flat,
                                               got.pin_epochs, log)
        assert dsnap.ts == got.snap.ts
        v, f = dseq.snapshot_read(np.arange(R_P), dsnap)
        assert_same(v, got.pinned[0], "pinned vals")
        assert_same(f, got.pinned[1], "pinned found")
        eng = got.svc.engine
        dseq.gc_sweep()
        eng.gc_sweep()
        assert_dicts_same(store_to_numpy(dseq.store),
                          store_to_numpy(eng.store), "dispatch-order store")

    run()
