"""The tracer, its export and validator, EWMA, the health monitor, the
stitched trace and the regression gate: the port's ``repro_torch.obs``
against the JAX reference's ``repro.obs`` (the cases of
``tests/test_obs.py``, ``tests/test_flight.py`` and
``tests/test_lifecycle.py``).

Host stamps are ``perf_counter`` reads, so both sides run on the same
scripted ``_clock``: exports, span durations, series and alerts must then
be EQUAL, ``dur_ms`` included (the port's spans wait only at a fenced
close, as the reference's do). The validator's verdicts and counts, the
regression gate's flags and the EWMA arithmetic are compared on the same
inputs.
"""
import itertools
import json

import numpy as np
import pytest

from repro.obs import EwmaAnomaly as RefAnomaly
from repro.obs import Ewma as RefEwma
from repro.obs import FlightRecorder as RefRecorder
from repro.obs import HealthMonitor as RefMonitor
from repro.obs import PhaseTracer as RefTracer
from repro.obs import check_history as ref_check_history
from repro.obs import direction_for as ref_direction_for
from repro.obs import stitch_chrome_trace as ref_stitch
from repro.obs import validate_chrome_trace as ref_validate
import repro_torch.device
from _torch_parity import inc_workloads
from repro_torch.core.engine import BohmEngine
from repro_torch.core.txn import make_batch
from repro_torch.obs import (NULL_MONITOR, NULL_SPAN, Ewma, EwmaAnomaly,
                             FlightRecorder, HealthMonitor, PhaseTracer,
                             append_entry, check_history, direction_for,
                             history_path, load_history,
                             stitch_chrome_trace, validate_chrome_trace)

R, T, OPS = 32, 8, 3


def _clock(step=0.00125, start=10.0):
    """A scripted perf_counter: start, start + step, ..."""
    it = itertools.count()
    return lambda: start + step * next(it)


def _both(make_ref, make_port, clock=_clock):
    ref, port = make_ref(), make_port()
    ref._clock, port._clock = clock(), clock()
    return ref, port


# ---------------------------------------------------------------- ewma
@pytest.mark.parametrize("alpha,threshold", [(0.1, 2.0), (0.5, 1.5),
                                             (1.0, 3.0)])
def test_ewma_and_anomaly_match_reference(alpha, threshold):
    """Seed by the first sample, flagged samples excluded from the
    baseline: values, flags, baselines and counts equal."""
    rng = np.random.default_rng(int(alpha * 10))
    xs = rng.lognormal(0.0, 0.8, 200).tolist()
    xs[50:53] = [40.0, 0.5, 60.0]                  # spikes
    ref_e, port_e = RefEwma(alpha), Ewma(alpha)
    assert [ref_e.update(x) for x in xs] == [port_e.update(x) for x in xs]
    assert (ref_e.n, ref_e.value) == (port_e.n, port_e.value)
    ref_a, port_a = RefAnomaly(alpha, threshold), EwmaAnomaly(alpha,
                                                              threshold)
    assert port_a.baseline is None
    flags = [(ref_a.record(x), port_a.record(x)) for x in xs]
    assert all(r == p for r, p in flags) and any(p for _, p in flags)
    assert not flags[0][1]                       # the first sample seeds
    assert (ref_a.n, ref_a.n_anomalies, ref_a.baseline) == \
        (port_a.n, port_a.n_anomalies, port_a.baseline)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            Ewma(bad)
    with pytest.raises(ValueError):
        EwmaAnomaly(threshold=0.0)


# -------------------------------------------------------------- tracer
def _script(tr):
    """Nested spans, an instant, notes and a fenced value."""
    with tr.span("outer", txns=32) as sp:
        with tr.span("inner"):
            pass
        tr.instant("decision", kind="merge")
        sp.note(result=7)
    for i in range(6):
        with tr.span("phase") as sp:
            sp.fence(i)
            if i == 4:                     # a slow one: 5 extra ticks
                for _ in range(5):
                    tr._clock()
    tr.instant("gc", reclaimed=3)


@pytest.mark.parametrize("threshold", [None, 2.0])
def test_tracer_chrome_export_matches_reference(threshold, tmp_path):
    """Same scripted clock on both sides: the Chrome export (dur_ms
    included), span durations, the event ring and the anomaly flags are
    equal, and the export validates with equal counts."""
    ref, port = _both(
        lambda: RefTracer(enabled=True, anomaly_alpha=0.5,
                          anomaly_threshold=threshold),
        lambda: PhaseTracer(enabled=True, anomaly_alpha=0.5,
                            anomaly_threshold=threshold))
    _script(ref)
    _script(port)
    want, got = ref.to_chrome_trace(), port.to_chrome_trace()
    assert want == got
    assert ref.events() == port.events()
    assert ref.span_durations() == port.span_durations()
    assert ref.anomalies == port.anomalies
    if threshold is not None:
        assert port.anomalies == {"phase": 1}
        flagged = [e for e in got["traceEvents"]
                   if e.get("args", {}).get("anomaly")]
        assert [e["name"] for e in flagged] == ["phase"]
    counts = validate_chrome_trace(got)
    assert counts == ref_validate(want)
    assert counts["spans"] == 8 and counts["instants"] == 2
    assert port.instants()[0][0] == "decision"
    path = tmp_path / "trace.json"
    port.export(path)
    assert validate_chrome_trace(json.loads(path.read_text())) == counts
    t0 = port._t0 - 1.0                           # a shared, earlier origin
    assert ref.to_chrome_trace(t0=t0) == port.to_chrome_trace(t0=t0)


def test_tracer_ring_overflow_matches_reference():
    """A ring of 8 events after 20 spans and an instant: the E orphaned
    at the head is skipped, 3 whole pairs remain and the export stays
    valid, equal to the reference's."""
    ref, port = _both(lambda: RefTracer(enabled=True, capacity=8),
                      lambda: PhaseTracer(enabled=True, capacity=8))
    for tr in (ref, port):
        for i in range(20):
            with tr.span(f"s{i}"):
                pass
        tr.instant("tail")                        # orphans the head E
    assert port.dropped == ref.dropped == 2 * 20 + 1 - 8
    assert ref.to_chrome_trace() == port.to_chrome_trace()
    counts = validate_chrome_trace(port.to_chrome_trace())
    assert counts == ref_validate(ref.to_chrome_trace())
    assert counts["spans"] == 3
    port.clear()
    assert port.events() == [] and port.dropped == 0 and port._t0 is None
    with pytest.raises(ValueError):
        PhaseTracer(capacity=1)


def _inc_batch(seed):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, R, (T, OPS))
    writes = np.where(rng.random((T, OPS)) < 0.6, reads, -1)
    return make_batch(reads, writes, rng.integers(0, 2, T),
                      rng.integers(1, 5, (T, 1)), device="cpu")


def test_disabled_tracer_never_fences(monkeypatch):
    """Disabled: NULL_SPAN, nothing recorded, and a run_batch stream +
    sweep makes zero ``repro_torch.device.fence`` calls; enabling the
    tracer is what adds them (one per fenced span: plan, exec, commit)."""
    tr = PhaseTracer(enabled=False)
    sp = tr.span("plan_phase", txns=8)
    assert sp is NULL_SPAN
    with sp as s:
        assert s.fence(123) == 123
        s.note(k=1)
    tr.instant("decision", x=1)
    assert tr.events() == [] and tr.instants() == []
    assert tr.to_chrome_trace()["traceEvents"] == []

    real = repro_torch.device.fence
    calls = {"n": 0}

    def counting(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(repro_torch.device, "fence", counting)
    batches = [_inc_batch(s) for s in range(3)]
    eng = BohmEngine(R, inc_workloads(OPS)[1], ring_slots=8, device="cpu")
    assert not eng.tracer.enabled
    for b in batches:
        eng.run_batch(b)
    eng.gc_sweep()
    assert calls["n"] == 0
    traced = BohmEngine(R, inc_workloads(OPS)[1], ring_slots=8,
                        device="cpu", tracer=PhaseTracer(enabled=True))
    traced.run_batch(batches[0])
    assert calls["n"] == 3
    assert validate_chrome_trace(
        traced.tracer.to_chrome_trace())["spans"] == 3


def _ev(ph, name, ts, **kw):
    return dict({"name": name, "ph": ph, "ts": ts, "pid": 1, "tid": 1},
                **kw)


_ASYNC_OK = {"name": "ticket", "ph": "b", "ts": 0, "pid": 0, "tid": 0,
             "cat": "flight", "id": "7"}
_COUNTER_OK = {"name": "health/x", "ph": "C", "ts": 1, "pid": 0, "tid": 0,
               "args": {"x": 1}}

# the reference tests' malformed traces (test_obs.py, test_flight.py,
# test_lifecycle.py) and the message each must be refused with
MALFORMED = [
    ({}, "not a list"),
    ({"traceEvents": [{"name": "a", "ph": "B", "pid": 1, "tid": 1}]},
     "missing 'ts'"),
    ({"traceEvents": [_ev("B", "a", 5), _ev("E", "a", 3)]}, "ts"),
    ({"traceEvents": [_ev("E", "a", 1)]}, "E without open B"),
    ({"traceEvents": [_ev("B", "a", 1), _ev("B", "b", 2),
                      _ev("E", "a", 3)]}, "closes B"),
    ({"traceEvents": [_ev("B", "a", 1)]}, "never closed"),
    ({"traceEvents": [_ev("X", "a", 1)]}, "unknown ph"),
    ({"traceEvents": [_ASYNC_OK, dict(_ASYNC_OK, ph="e", id="8")]},
     "without open"),
    ({"traceEvents": [{k: v for k, v in _ASYNC_OK.items() if k != "id"}]},
     "missing 'id'"),
    ({"traceEvents": [_ASYNC_OK]}, "never closed"),
    ({"traceEvents": [dict(_COUNTER_OK, args={})]}, "counter"),
]


@pytest.mark.parametrize("trace,match", MALFORMED)
def test_validator_refuses_what_the_reference_refuses(trace, match):
    with pytest.raises(ValueError, match=match) as want:
        ref_validate(trace)
    with pytest.raises(ValueError, match=match) as got:
        validate_chrome_trace(trace)
    assert str(want.value) == str(got.value)


def test_validator_counts_match_reference():
    trace = {"traceEvents": [
        _ev("B", "a", 0), _ev("i", "d", 1, s="t"), _ev("E", "a", 2),
        dict(_ASYNC_OK, ts=3), dict(_ASYNC_OK, ph="n", name="blocked", ts=4),
        dict(_ASYNC_OK, ph="e", ts=5), dict(_COUNTER_OK, ts=6)]}
    counts = validate_chrome_trace(trace)
    assert counts == ref_validate(trace)
    assert counts == {"spans": 1, "instants": 1, "async_spans": 1,
                      "async_lanes": 1, "counters": 1, "events": 7}


# ------------------------------------------------------------- monitor
class _FakeTarget:
    """Scripted health() source (``test_lifecycle.py``'s)."""

    def __init__(self, lags):
        self.lags = list(lags)

    def health(self):
        lag = self.lags.pop(0) if self.lags else 0.0
        return {"watermark_lag": lag, "ring_fill_p99": 0.5,
                "spill_fill_by_shard": [0.1, 0.3],
                "flight_slo": {"bulk": {"p99_ms": 5.0}},
                "lifecycle_states": {"committed": 3},
                "label": "not-a-number"}


def test_monitor_series_alerts_and_jsonl_match_reference(tmp_path):
    """Baseline ~1.0, then 3x (warn) and 10x (crit): series, alerts,
    baselines, the event log and the JSONL lines equal."""
    lags = [1.0, 1.0, 3.0, 10.0, 1.0, 2.5]
    logs = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    ref, port = _both(
        lambda: RefMonitor(_FakeTarget(lags), alpha=0.5, threshold=2.0,
                           log_path=str(logs[0])),
        lambda: HealthMonitor(_FakeTarget(lags), alpha=0.5, threshold=2.0,
                              log_path=str(logs[1])))
    taken = [(ref.sample(), port.sample()) for _ in lags]
    assert all(r == p for r, p in taken)
    assert taken[0][1]["spill_fill_max"] == 0.3
    assert taken[0][1]["flight_p99_ms"] == 5.0
    assert ref.keys() == port.keys()
    for k in port.keys():
        assert ref.series(k) == port.series(k)
    assert ref.events() == port.events()
    assert [e["severity"] for e in port.events()
            if e["gauge"] == "watermark_lag"] == ["warn", "crit", "warn"]
    assert ref.alerts == port.alerts and ref.latest() == port.latest()
    assert ref.baselines() == port.baselines()
    assert logs[0].read_text() == logs[1].read_text()
    assert [json.loads(x) for x in logs[1].read_text().splitlines()] == \
        port.events()
    assert ref.to_counter_events(9.0) == port.to_counter_events(9.0)
    assert (ref.samples, ref.dropped) == (port.samples, port.dropped)


def test_monitor_cadence_capacity_and_null():
    mon = HealthMonitor(_FakeTarget([1.0, 2.0]), cadence_s=3600.0)
    assert mon.tick() is not None
    assert mon.tick() is None
    assert mon.samples == 1
    small = HealthMonitor(_FakeTarget([1.0] * 5), capacity=2)
    for _ in range(5):
        small.sample()
    assert len(small.series("watermark_lag")) == 2 and small.dropped > 0
    assert NULL_MONITOR.tick() is None
    assert NULL_MONITOR.sample() == {}
    assert NULL_MONITOR.samples == 0
    with pytest.raises(ValueError):
        HealthMonitor(None, capacity=0)


def _flight_script(rec):
    rec.on_submit(0, 0, 16)
    rec.on_submit(1, 1, 16)
    rec.on_dispatch([0, 1], epoch=0, epoch_txns=32, epoch_batches=2)
    rec.on_blocked(1, "epoch-conflict", blocker=0, witness=42)
    rec.on_exec([0, 1], chain_depth=2)
    rec.on_commit([0, 1])
    rec.on_visible(0)
    rec.on_visible(1)


@pytest.mark.parametrize("with_monitor", [False, True])
def test_stitch_chrome_trace_matches_reference(with_monitor):
    """Tracer spans + flight lanes (+ monitor counter tracks) on one
    shared time origin, on interleaved scripted clocks: the stitched
    traces are equal and validate with spans, lanes and counters."""
    def run(tracer, rec, mon):
        clock = _clock(start=5.0)
        tracer._clock = rec._clock = clock
        if mon is not None:
            mon._clock = clock
        _flight_script(rec)
        for _ in range(3):
            with tracer.span("plan", txns=32):
                pass
            if mon is not None:
                mon.sample()
        return tracer, rec, mon

    ref = run(RefTracer(enabled=True), RefRecorder(enabled=True),
              RefMonitor(_FakeTarget([1.0, 2.0, 3.0]))
              if with_monitor else None)
    port = run(PhaseTracer(enabled=True), FlightRecorder(enabled=True),
               HealthMonitor(_FakeTarget([1.0, 2.0, 3.0]))
               if with_monitor else None)
    want = ref_stitch(ref[0], ref[1], monitor=ref[2])
    got = stitch_chrome_trace(port[0], port[1], monitor=port[2])
    assert want == got
    counts = validate_chrome_trace(got)
    assert counts == ref_validate(want)
    assert counts["spans"] == 3 and counts["async_lanes"] == 2
    assert got["otherData"]["flight_tickets"] == 2
    if with_monitor:
        assert counts["counters"] == 3 * len(port[2].keys()) > 0
        assert got["otherData"]["health_samples"] == 3
    assert json.loads(json.dumps(got)) == got
    # a disabled recorder contributes nothing but its counters
    tr = PhaseTracer(enabled=True)
    with tr.span("plan"):
        pass
    assert validate_chrome_trace(stitch_chrome_trace(
        tr, FlightRecorder(enabled=False)))["spans"] == 1


# ---------------------------------------------------------- regression
_NAMES = ["txn_s", "vs_barriered", "p99_ms", "us_per_txn", "found_rate",
          "hit_rate", "speedup", "ops_per_s", "abort_rate", "gc_s",
          "lat_us", "lat_ns", "pages_dropped", "alloc_failed", "pin_lag",
          "peak_bytes", "committed", "waves", "x_s"]


def test_regress_directions_match_reference():
    for name in _NAMES:
        assert direction_for(name) == ref_direction_for(name), name
    assert direction_for("txn_s") == "higher"
    assert direction_for("p99_ms") == "lower"


@pytest.mark.parametrize("stream", [
    {"txn_s": [1000.0] * 5 + [200.0], "p99_ms": [4.0] * 5 + [40.0]},
    {"txn_s": [1000.0, 1000.0, 1000.0, 5000.0]},
    {"txn_s": [1000.0, 1000.0], "p99_ms": [1.0, 9.0]},
    {"m_us": [3.0, 3.3, 2.9, 3.1, 7.0], "rate_per_s": [5.0, 0.0, 5.0, 1.0]},
])
def test_regress_gate_matches_reference(stream, tmp_path):
    """Equal histories in ``tmp_path`` get equal verdicts."""
    path = history_path("demo", str(tmp_path))
    n = max(len(v) for v in stream.values())
    for i in range(n):
        append_entry(path, "demo", {k: v[i] for k, v in stream.items()
                                    if i < len(v)}, meta={"i": i})
    hist = load_history(path)
    for kw in ({}, {"threshold": 1.2, "alpha": 0.5, "min_entries": 2}):
        want = ref_check_history(hist, **kw)
        got = check_history(hist, **kw)
        assert [tuple(vars(r).values()) for r in want] == \
            [tuple(vars(r).values()) for r in got]
        assert [r.describe() for r in want] == [r.describe() for r in got]


def test_regress_history_bounded_and_stamped(tmp_path):
    path = history_path("cap", str(tmp_path))
    assert load_history(path, "cap") == {"suite": "cap", "entries": []}
    for i in range(8):
        append_entry(path, "cap", {"m_us": float(i), "label": "x"},
                     max_entries=5)
    hist = load_history(path)
    assert [e["metrics"]["m_us"] for e in hist["entries"]] == \
        [3.0, 4.0, 5.0, 6.0, 7.0]
    meta = hist["entries"][-1]["meta"]
    assert "torch_version" in meta and "git_sha" in meta
    assert "jax_version" not in meta
    with pytest.raises(ValueError):
        append_entry(path, "cap", {"label": "only text"})
    (tmp_path / "bad.json").write_text('{"entries": 3}')
    with pytest.raises(ValueError):
        load_history(str(tmp_path / "bad.json"))
