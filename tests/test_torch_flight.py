"""Flight recorder, quantile digests and health gauges: the port's
``repro_torch.obs`` against the JAX reference's ``repro.obs`` — the cases
of ``tests/test_flight.py`` (the Chrome-trace stitch, its validator and
the regression gate wait for the tracer's export) and the health cases of
``tests/test_obs.py``.

* Zero fences: ``repro_torch.device.fence`` is counted with the recorder
  off and on — equal counts, byte-equal results.
* Telescoping breakdowns and per-class SLO gauges on the port.
* Conflict attribution: on the same stream, every ticket's (kind,
  blocker, witness) events and the heatmaps equal the reference
  recorder's.
* Host stamps are ``perf_counter`` reads, so timing-derived values are
  compared on an injected clock or injected samples, where both sides
  must agree exactly; the capacity bound likewise.
* ``engine_health`` / ``service_health``: equal key sets, equal
  deterministic values (every gauge but the wall-clock ages).
"""
import itertools

import numpy as np
import pytest

from _torch_parity import fresh_ref_engine, inc_workloads, np_
from repro.core.txn import make_batch as ref_make_batch
from repro.obs import FlightRecorder as RefRecorder
from repro.obs import LogHistogram as RefHistogram
from repro.service import TxnService as RefService
import repro_torch.device
from repro_torch.core.engine import BohmEngine
from repro_torch.core.txn import make_batch
from repro_torch.obs import (NULL_FLIGHT, FlightRecorder, LogHistogram,
                             engine_health, service_health)
from repro_torch.service import TxnService

T, OPS, R = 16, 3, 64
WALL_CLOCK = {"oldest_pin_age_s", "scheduler_max_ticket_age_s",
              "flight_slo"}


def _random(seed, lo=0, hi=R, t=T):
    rng = np.random.default_rng(seed)
    reads = rng.integers(lo, hi, (t, OPS))
    writes = np.where(rng.random((t, OPS)) < 0.6, reads, -1)
    return (reads, writes, rng.integers(0, 2, t), rng.integers(1, 5, (t, 1)))


def _engine(side, **kw):
    if side == "ref":
        return fresh_ref_engine(R, "inc", lambda: inc_workloads(OPS)[0],
                                **kw)
    return BohmEngine(R, inc_workloads(OPS)[1], device="cpu", **kw)


def _run_stream(side="port", flight=None, stream=None):
    """``test_flight.py``'s conflict-aware OOO stream: six random batches
    in a burst, then an interactive point batch; every ticket waited."""
    eng = _engine(side, ring_slots=8)
    cls, mk = (RefService, ref_make_batch) if side == "ref" else \
        (TxnService, lambda *a: make_batch(*a, device="cpu"))
    svc = cls(eng, max_inflight=2, admission_window=4, max_inflight_execs=2,
              flight=flight)
    if stream is None:
        tickets = svc.submit_many([mk(*_random(s)) for s in range(6)])
        tickets.append(svc.submit(mk(*_random(99, hi=8, t=4)),
                                  latency_class="interactive"))
    else:
        tickets = svc.submit_many([mk(*a) for a in stream])
    reads = [np_(svc.wait(t).read_vals) for t in tickets]
    svc.drain()
    return svc, reads


# ------------------------------------------------------- zero-sync contract
def test_flight_adds_zero_fences_and_results_identical(monkeypatch):
    """The recorder, off or on, adds no join: the service's joins all go
    through ``repro_torch.device.fence`` and their count does not move;
    every read result stays byte-identical."""
    _, want = _run_stream(flight=None)
    real = repro_torch.device.fence
    calls = {"n": 0}

    def counting(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(repro_torch.device, "fence", counting)
    fences = {}
    for name, flight in [("off", FlightRecorder(enabled=False)),
                         ("on", FlightRecorder(enabled=True))]:
        calls["n"] = 0
        svc, got = _run_stream(flight=flight)
        fences[name] = calls["n"]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        assert svc.flight is flight
    # 7 waits, the backpressure joins and the drain
    assert fences["on"] == fences["off"] >= 8


def test_null_flight_records_nothing():
    svc, _ = _run_stream(flight=FlightRecorder(enabled=False))
    assert not svc.flight.records() and not svc.flight.inflight()
    assert svc.flight.completed == 0
    assert NULL_FLIGHT.records() == []


# -------------------------------------------------- breakdown + SLO gauges
def test_breakdown_telescopes_and_health_slo():
    flight = FlightRecorder(enabled=True)
    svc, _ = _run_stream(flight=flight)
    recs = flight.records()
    assert len(recs) == 7 and flight.completed == 7
    for f in recs:
        assert f.complete
        bd = f.breakdown()
        parts = sum(bd[p] for p in ("queue", "formation", "exec",
                                    "commit_defer"))
        assert parts == pytest.approx(bd["total"], abs=1e-9)
        assert all(v >= 0 for v in bd.values())
        assert bd["total"] == f.t_visible - f.t_submit
    health = svc.health()
    slo = health["flight_slo"]
    assert set(slo) == {"interactive", "bulk"}
    assert slo["interactive"]["count"] == 1 and slo["bulk"]["count"] == 6
    for g in slo.values():
        assert 0 < g["p50_ms"] <= g["p99_ms"]
    assert health["flight_completed"] == 7
    assert health["flight_inflight"] == 0
    snap = svc.metrics.snapshot()
    assert snap["flight/completed"] == 7


# ------------------------------------------------ conflict attribution
def _attribution(rec):
    """Everything the recorder holds that is not a clock reading."""
    return {
        "tickets": [(f.ticket, f.latency_class, f.n_txns, f.epoch,
                     f.epoch_txns, f.epoch_batches, f.chain_depth, f.hops,
                     f.saturated, f.blocked_dropped,
                     [(k, b, w) for _, k, b, w in f.blocked])
                    for f in rec.records()],
        "blocking_records": dict(rec.blocking_records),
        "blocking_tickets": dict(rec.blocking_tickets),
        "block_kinds": dict(rec.block_kinds),
        "top": rec.blocking_top(), "completed": rec.completed,
        "dropped": rec.dropped, "inflight": rec.inflight(),
        "counts": {k: d.count for k, d in rec.digests.items()},
    }


@pytest.mark.parametrize("stream", ["mixed", "hot"])
def test_conflict_attribution_equals_reference(stream):
    """Every ticket's (kind, blocker, witness) events, lifecycle fields
    and the heatmaps equal the reference recorder's on the same stream;
    the hot stream (every batch on 8 records) must block with real
    witnesses."""
    arrays = None if stream == "mixed" else \
        [_random(s, hi=8) for s in range(6)]
    ref = RefRecorder(enabled=True)
    port = FlightRecorder(enabled=True)
    _, ref_reads = _run_stream("ref", ref, arrays)
    svc, reads = _run_stream("port", port, arrays)
    for a, b in zip(ref_reads, reads):
        np.testing.assert_array_equal(a, b)
    assert _attribution(port) == _attribution(ref)
    if stream == "hot":
        assert port.block_kinds.get("epoch-conflict", 0) > 0
        top = port.blocking_top()
        assert top and all(n >= 1 for _, n in top)
        assert [n for _, n in top] == sorted((n for _, n in top),
                                             reverse=True)
        assert all(0 <= rec < R for rec, _ in top)


# --------------------------------------- injected clock: lanes and digests
def _script(rec):
    """A fixed hook sequence (two tickets merged, one blocked, a hop and
    a saturation, then ten singletons)."""
    rec.on_submit(0, 0, 16)
    rec.on_submit(1, 1, 16)
    rec.on_dispatch([0, 1], epoch=0, epoch_txns=32, epoch_batches=2)
    rec.on_blocked(1, "epoch-conflict", blocker=0, witness=42)
    rec.on_hop(1, 1)
    rec.on_saturate(1)
    rec.on_exec([0, 1], chain_depth=2)
    rec.on_commit([0, 1])
    rec.on_visible(0)
    rec.on_visible(1)
    for tk in range(2, 12):
        rec.on_submit(tk, 1, 1)
        rec.on_dispatch([tk], epoch=tk, epoch_txns=1, epoch_batches=1)
        rec.on_blocked(tk, "hop-saturated", blocker=1, witness=None)
        rec.on_exec([tk])
        rec.on_commit([tk])
        rec.on_visible(tk)


def test_recorder_equals_reference_on_an_injected_clock():
    """Same hooks, same clock: the async lanes, quantiles, breakdowns and
    aggregates equal the reference recorder's exactly."""
    recs = []
    for cls in (RefRecorder, FlightRecorder):
        rec = cls(enabled=True, capacity=8)
        ticks = itertools.count()
        rec._clock = lambda: 1.0 + 1e-3 * next(ticks) ** 1.5
        _script(rec)
        recs.append(rec)
    ref, port = recs
    assert port.to_async_events(t0=1.0) == ref.to_async_events(t0=1.0)
    assert port.class_quantiles() == ref.class_quantiles()
    assert [f.breakdown() for f in port.records()] == \
        [f.breakdown() for f in ref.records()]
    assert _attribution(port) == _attribution(ref)
    assert port.dropped == ref.dropped == 4
    assert port.earliest_ts() == ref.earliest_ts()


def test_flight_capacity_bounded():
    flight = FlightRecorder(capacity=4, enabled=True)
    for tk in range(10):
        flight.on_submit(tk, 1, 1)
        flight.on_dispatch([tk], epoch=tk, epoch_txns=1, epoch_batches=1)
        flight.on_exec([tk])
        flight.on_commit([tk])
        flight.on_visible(tk)
    assert len(flight.records()) == 4
    assert flight.dropped == 6
    assert flight.completed == 10
    assert [f.ticket for f in flight.records()] == [6, 7, 8, 9]


# ------------------------------------------------------ quantile digests
def test_log_histogram_equals_reference():
    rng = np.random.default_rng(3)
    xs = rng.lognormal(mean=-7.0, sigma=1.2, size=4000)
    h, ref = LogHistogram(), RefHistogram()
    h.extend(xs)
    ref.extend(xs)
    qs = (0.0, 1.0, 50.0, 90.0, 99.0, 99.9, 100.0)
    assert h.quantiles(qs) == ref.quantiles(qs)
    assert h.to_dict() == ref.to_dict()
    for q in (50.0, 90.0, 99.0):
        assert h.quantile(q) == pytest.approx(float(np.percentile(xs, q)),
                                              rel=2 * h.rel_error)
    assert h.mean == pytest.approx(xs.mean(), rel=1e-9)
    h2, h3 = LogHistogram(), LogHistogram()
    h2.extend(xs[:1000])
    h3.extend(xs[1000:])
    h2.merge(h3)
    assert h2.quantile(99.0) == pytest.approx(h.quantile(99.0))
    back = LogHistogram.from_dict(ref.to_dict())
    assert back.quantile(50.0) == ref.quantile(50.0)
    with pytest.raises(ValueError):
        h.merge(LogHistogram(n_buckets=8))


# ----------------------------------------------------------- health gauges
def _deterministic(h):
    return {k: v for k, v in h.items() if k not in WALL_CLOCK}


@pytest.mark.parametrize("cfg", [
    {},                                          # dense rings + spill
    {"spill_slots": 0},                          # bare rings
    {"paged": True, "spill_slots": 0},           # paged slab
    {"adaptive_k": True},                        # adaptive-K + spill
])
def test_engine_health_equals_reference(cfg):
    hs = []
    for side in ("ref", "port"):
        eng = _engine(side, ring_slots=2, **cfg)
        mk = ref_make_batch if side == "ref" else \
            (lambda *a: make_batch(*a, device="cpu"))
        for s in range(4):
            eng.run_batch(mk(*_random(s)))
        snap = eng.begin_snapshot()
        eng.run_batch(mk(*_random(9)))
        hs.append((eng, snap, eng.health()))
    (_, _, ref), (eng, snap, h) = hs
    assert set(h) == set(ref)
    assert _deterministic(h) == _deterministic(ref)
    assert set(engine_health(eng)) == set(h)
    assert h["ts_counter"] == 5 * T
    assert h["active_pins"] == 1 and h["oldest_pin_ts"] == snap.ts
    assert h["oldest_pin_lag_ts"] == 5 * T - snap.ts
    assert h["oldest_pin_age_s"] >= 0.0
    assert 0.0 <= h["ring_fill_p50"] <= h["ring_fill_max"] <= 1.0
    eng.release_snapshot(snap)
    assert eng.health()["active_pins"] == 0


def test_service_health_equals_reference():
    out = []
    for side in ("ref", "port"):
        eng = _engine(side, ring_slots=8)
        cls, mk = (RefService, ref_make_batch) if side == "ref" else \
            (TxnService, lambda *a: make_batch(*a, device="cpu"))
        svc = cls(eng, max_inflight=2, admission_window=4,
                  flight=(RefRecorder if side == "ref"
                          else FlightRecorder)(enabled=True))
        svc.submit(mk(*_random(0)))              # held: window not full
        held = svc.health()
        svc.drain()
        out.append((held, svc.health()))
    (ref_held, ref_done), (held, done) = out
    for a, b in ((ref_held, held), (ref_done, done)):
        assert set(b) == set(a)
        assert _deterministic(b) == _deterministic(a)
    assert held["admission_queue_depth"] == 1
    assert held["admission_window"] == 4
    assert done["admission_queue_depth"] == 0
    assert done["inflight_epochs"] == 0 and done["unclaimed_results"] == 0
    assert done["admission_window_occupancy_max"] >= 1
    assert service_health.__module__ == "repro_torch.obs.health"
