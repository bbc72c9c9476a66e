"""BohmEngine parity: the port (``device="cpu"``) against the JAX reference
on the same seeded streams, at R=256, T=64, with the default engine
configuration (``ring_slots=4``, spill tier on).

Compared byte for byte: per-batch ``read_vals`` and integer metrics, the
head store, ``base_ts``, ``ts_counter``, ring and spill arrays, pinned
``snapshot_read`` / ``run_readonly_batch`` values and ``found`` before and
after ``gc_sweep``, ``overflow_stats()``, ``spill_stats()`` and the
registry's integer counters. The float32 gauges ``ring_occ_mean`` and
``found_frac`` are compared to rtol=1e-6 (summation order may differ).
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_dicts_same, assert_same, fresh_ref_engine,
                           np_, port_batch, ref_store_arrays)
from repro.core import workloads as ref_wl
from repro.core.engine import serial_oracle as ref_serial_oracle
from repro_torch.core import workloads as port_wl
from repro_torch.core.carry import store_to_numpy
from repro_torch.core.engine import BohmEngine, serial_oracle
from repro_torch.obs import PhaseTracer

R, T = 256, 64
STREAMS = ["ycsb/0.0/10rmw", "ycsb/0.0/2rmw8r", "ycsb/0.9/10rmw",
           "ycsb/0.9/2rmw8r", "ycsb/0.99/10rmw", "ycsb/0.99/2rmw8r",
           "smallbank"]


def _ref_workload(kind):
    if kind == "smallbank":
        return ref_wl.make_smallbank()
    return ref_wl.make_ycsb(payload_words=8)


def _workloads(kind):
    if kind == "smallbank":
        return ref_wl.make_smallbank(), port_wl.make_smallbank()
    return (ref_wl.make_ycsb(payload_words=8),
            port_wl.make_ycsb(payload_words=8))


def _batches(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "smallbank":
        return [ref_wl.gen_smallbank_batch(rng, T, R // 2) for _ in range(n)]
    _, theta, mix = kind.split("/")
    return [ref_wl.gen_ycsb_batch(rng, T, R, theta=float(theta), mix=mix)
            for _ in range(n)]


def _engines(kind, **kw):
    name = "smallbank" if kind == "smallbank" else "ycsb"
    ref = fresh_ref_engine(R, name, lambda: _ref_workload(kind), **kw)
    return ref, BohmEngine(R, _workloads(kind)[1], device="cpu", **kw)


def _run_both(ref, port, batch, msg):
    r_vals, r_m = ref.run_batch(batch)
    p_vals, p_m = port.run_batch(port_batch(batch))
    assert_same(r_vals, p_vals, f"{msg}: read_vals")
    assert_dicts_same(r_m, p_m, msg)


def _counters(eng):
    snap = eng.metrics.snapshot()
    return {k: v for k, v in snap.items() if k.startswith("engine/")}


def _check_state(ref, port, msg):
    assert_dicts_same(ref_store_arrays(ref.store),
                      store_to_numpy(port.store), f"{msg}: store")
    assert ref.overflow_stats() == port.overflow_stats(), msg
    assert ref.spill_stats() == port.spill_stats(), msg
    assert_dicts_same(_counters(ref), _counters(port), f"{msg}: counters")
    assert ref.watermark() == port.watermark()
    assert ref.current_ts() == port.current_ts()


def _check_reads(ref, port, pins, scan, msg):
    recs = np.arange(R)
    for (r_pin, p_pin) in pins:
        assert_same(np_(ref.pin_array()), np_(port.pin_array()), msg)
        for a, b in zip(ref.snapshot_read(recs, r_pin),
                        port.snapshot_read(recs, p_pin)):
            assert_same(a, b, f"{msg}: snapshot_read@{r_pin.ts}")
        r_v, r_f, r_m = ref.run_readonly_batch(scan, r_pin)
        p_v, p_f, p_m = port.run_readonly_batch(port_batch(scan), p_pin)
        assert_same(r_v, p_v, f"{msg}: readonly vals")
        assert_same(r_f, p_f, f"{msg}: readonly found")
        assert_dicts_same(r_m, p_m, f"{msg}: readonly metrics")
    for a, b in zip(ref.snapshot_read(recs), port.snapshot_read(recs)):
        assert_same(a, b, f"{msg}: snapshot_read@now")


@pytest.mark.parametrize("kind", STREAMS)
def test_engine_stream_parity(kind):
    ref, port = _engines(kind)
    batches = _batches(kind, 6, STREAMS.index(kind))
    scan = ref_wl.gen_scan_batch(np.random.default_rng(99), 16, R, ops=10)
    pins = []
    for i, batch in enumerate(batches):
        _run_both(ref, port, batch, f"{kind} batch {i}")
        if i in (1, 3):                       # pin mid-stream
            pins.append((ref.begin_snapshot(), port.begin_snapshot()))
    _check_state(ref, port, kind)
    _check_reads(ref, port, pins, scan, f"{kind} before gc")
    assert ref.gc_sweep() == port.gc_sweep()
    _check_state(ref, port, f"{kind} after gc")
    _check_reads(ref, port, pins, scan, f"{kind} after gc")
    for r_pin, p_pin in pins:                 # release all, drain
        ref.release_snapshot(r_pin)
        port.release_snapshot(p_pin)
    assert ref.gc_sweep() == port.gc_sweep()
    _check_state(ref, port, f"{kind} drained")
    if kind == "ycsb/0.99/10rmw":             # the hot stream spills
        assert port.spill_stats()["spill_admitted"] > 0


def test_saturated_spill_parity():
    """A small ring and a small spill pool under many pins, one of them
    released mid-stream: evictees must overwrite (unpinned history first,
    pinned last) and drop — still byte-equal."""
    kind = "ycsb/0.99/10rmw"
    ref, port = _engines(kind, ring_slots=2, spill_buckets=16,
                         spill_slots=8)
    scan = ref_wl.gen_scan_batch(np.random.default_rng(98), 16, R, ops=10)
    pins = []
    for i, batch in enumerate(_batches(kind, 6, 31)):
        _run_both(ref, port, batch, f"saturated batch {i}")
        pins.append((ref.begin_snapshot(), port.begin_snapshot()))
        if i == 3:                            # release an older pin
            ref.release_snapshot(pins[1][0])
            port.release_snapshot(pins.pop(1)[1])
    _check_state(ref, port, "saturated")
    stats = port.spill_stats()
    assert stats["spill_dropped"] > 0 and stats["spill_overwrote_pinned"] > 0
    _check_reads(ref, port, pins, scan, "saturated")
    assert ref.gc_sweep() == port.gc_sweep()
    _check_reads(ref, port, pins, scan, "saturated after gc")
    _check_state(ref, port, "saturated after gc")


@pytest.mark.parametrize("kind", ["ycsb/0.9/10rmw", "smallbank"])
def test_serial_oracle_parity(kind):
    ref_w, port_w = _workloads(kind)
    batch = _batches(kind, 1, 7)[0]
    base = np.random.default_rng(1).integers(-50, 50, (R, ref_w.payload_words)
                                             ).astype(np.int32)
    r_final, r_reads = ref_serial_oracle(base, batch, ref_w)
    p_final, p_reads = serial_oracle(torch.from_numpy(base.copy()),
                                     port_batch(batch), port_w)
    assert_same(r_final, p_final, "final")
    assert_same(r_reads, p_reads, "reads")
    # the engine's first batch is serializable: equal to the oracle
    port = BohmEngine(R, port_w, device="cpu")
    port.reset_store(torch.from_numpy(base.copy()))
    vals, _ = port.run_batch(port_batch(batch))
    assert_same(p_reads, vals, "engine reads")
    assert_same(p_final, port.snapshot(), "engine head store")


def test_carry_across_from_reference():
    """The reference runs 3 batches; its state (store, next ts, pin) is
    handed to the port; both run 3 more and everything stays equal."""
    kind = "ycsb/0.99/10rmw"
    ref, port = _engines(kind)
    batches = _batches(kind, 6, 21)
    for batch in batches[:3]:
        ref.run_batch(batch)
    r_pin = ref.begin_snapshot()
    (p_pin,) = port.load_state(ref_store_arrays(ref.store), ref._ts_next,
                               pins=[r_pin.ts])
    assert_dicts_same(ref_store_arrays(ref.store),
                      store_to_numpy(port.store), "after load")
    for i, batch in enumerate(batches[3:]):
        _run_both(ref, port, batch, f"carried batch {i}")
    assert_dicts_same(ref_store_arrays(ref.store),
                      store_to_numpy(port.store), "carried store")
    scan = ref_wl.gen_scan_batch(np.random.default_rng(3), 16, R, ops=10)
    _check_reads(ref, port, [(r_pin, p_pin)], scan, "carried")
    assert ref.gc_sweep() == port.gc_sweep()
    assert_dicts_same(ref_store_arrays(ref.store),
                      store_to_numpy(port.store), "carried, swept")


def test_enabled_tracer_times_phases_without_changing_results():
    """An enabled PhaseTracer records one span per phase per batch (and
    per read-only batch and sweep) and leaves every result byte-equal."""
    kind = "ycsb/0.9/10rmw"
    ref, _ = _engines(kind)
    port = BohmEngine(R, _workloads(kind)[1], device="cpu",
                      tracer=PhaseTracer(enabled=True, annotate=True))
    for i, batch in enumerate(_batches(kind, 3, 5)):
        _run_both(ref, port, batch, f"traced batch {i}")
    pin = (ref.begin_snapshot(), port.begin_snapshot())
    scan = ref_wl.gen_scan_batch(np.random.default_rng(4), 16, R, ops=10)
    _check_reads(ref, port, [pin], scan, "traced")
    assert ref.gc_sweep() == port.gc_sweep()
    _check_state(ref, port, "traced")
    spans = port.tracer.span_durations()
    for name in ("plan_phase", "exec_phase", "commit_phase"):
        assert len(spans[name]) == 3 and min(spans[name]) >= 0, name
    assert len(spans["read/resolve"]) == 1 and len(spans["gc_sweep"]) == 1
    port.tracer.clear()
    assert port.tracer.span_durations() == {}
