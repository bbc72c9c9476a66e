"""The lifecycle auditor and the store's audit taps: the port's
``repro_torch.obs.lifecycle`` and ``with_audit=True`` commit paths
against the JAX reference's ``repro.obs.lifecycle`` on the same numpy
streams (the cases of ``tests/test_lifecycle.py``).

* The taps, byte-equal: the raw ``audit_*`` arrays of ``commit_versions``,
  ``spill_commit``, ``commit_paged`` and ``commit_sharded`` (1 and 2
  shards, spill on and off), and ``gc_sharded_audited``'s dict.
* The auditor, equal: harvested ``AuditEvent`` lists, ``state_counts``,
  ``telescope``, ``gc_report``, ``explain_read`` for every record at a
  held pin, and ``health()``'s ``lifecycle_*`` keys.
* The invariants on the port: the telescope balances and no sweep
  reclaims a pinned version over the reference's seeded interleavings.
* The zero-fence contract: ``repro_torch.device.fence`` counted with the
  auditor off and on — equal counts, reads and store byte-equal to an
  engine with no auditor; no audit key leaks into results; ``NULL_AUDIT``
  is inert; ``inspect_record`` raises without an auditor.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_dicts_same, dataclass_arrays,
                           fresh_ref_engine, inc_workloads, np_,
                           ref_store_arrays)
from repro.core.execute import execute_plan as ref_execute
from repro.core.plan import cc_plan as ref_cc_plan
from repro.core.txn import make_batch as ref_make_batch
from repro.obs import LifecycleAuditor as RefAuditor
from repro.store import pages as ref_pages
from repro.store import sharded as ref_sh
from repro.store.ring import VersionRing as RefRing
from repro.store.ring import commit_versions as ref_commit_versions
from repro.store.spill import SpillPool as RefPool
from repro.store.spill import spill_commit as ref_spill_commit
import repro_torch.device
from repro_torch.core.carry import store_to_numpy
from repro_torch.core.engine import BohmEngine
from repro_torch.core.txn import make_batch
from repro_torch.obs import NULL_AUDIT, LifecycleAuditor
from repro_torch.obs.lifecycle import (AUDIT_COMMITTED, AUDIT_GC_RECLAIMED,
                                       AUDIT_STATE_NAMES)
from repro_torch.service import TxnService
from repro_torch.store import gc_sharded_audited, pages
from repro_torch.store.ring import VersionRing, commit_versions
from repro_torch.store.spill import SpillPool, spill_commit

T, OPS, R = 16, 3, 24
HOT = 8
AUDIT_KW = dict(capacity=1 << 16, pending_cap=1 << 10,
                per_record_cap=1 << 12)


def _t(x):
    return torch.tensor(np_(x))


def _random(rng, lo=0, hi=R, t=T, w_prob=0.6):
    """``test_lifecycle.py``'s batch: (reads, writes, types, args)."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    reads = rng.integers(lo, hi, (t, OPS))
    writes = np.where(rng.random((t, OPS)) < w_prob, reads, -1)
    return (reads, writes, rng.integers(0, 2, t),
            rng.integers(1, 5, (t, 1)))


def _batch(side, arrays):
    return ref_make_batch(*arrays) if side == "ref" else \
        make_batch(*arrays, device="cpu")


def _config_kw(config, n_shards, num_records=R):
    if config == "spill":
        return dict(ring_slots=4, n_shards=n_shards, spill_buckets=4,
                    spill_slots=4)
    if config == "nospill":
        return dict(ring_slots=4, n_shards=n_shards, spill_slots=0)
    # paged: a few pages of headroom over the one-page-per-record floor
    # so hot records hit allocation failure under load
    local = -(-num_records // n_shards)
    return dict(ring_slots=4, n_shards=n_shards, paged=True, page_slots=2,
                pages_per_shard=local + 4, spill_slots=0)


def _pair(kw, audited=True):
    """(reference, port) engines of one configuration with fresh
    auditors (or none)."""
    ref = fresh_ref_engine(R, "inc", lambda: inc_workloads(OPS)[0],
                           auditor=RefAuditor(**AUDIT_KW) if audited
                           else None, **kw)
    port = BohmEngine(R, inc_workloads(OPS)[1], device="cpu",
                      auditor=LifecycleAuditor(**AUDIT_KW) if audited
                      else None, **kw)
    return ref, port


def _events(auditor, **kw):
    return [dataclasses.astuple(e) for e in auditor.events(**kw)]


def _assert_audits_equal(ref, port, msg):
    ra, pa = ref.auditor, port.auditor
    assert _events(ra) == _events(pa), msg
    assert ra.state_counts() == pa.state_counts(), msg
    assert ra.telescope() == pa.telescope(), msg
    assert ra.gc_report() == pa.gc_report(), msg
    assert (ra.events_dropped, ra.pending_dropped, ra.gc_sweeps) == \
        (pa.events_dropped, pa.pending_dropped, pa.gc_sweeps), msg


# ---------------------------------------------------------------------------
# 1. the store's taps, array by array
# ---------------------------------------------------------------------------
def _next_commit(config, seed, n_batches=4):
    """A reference engine (a cached audited one) after a pinned,
    overflowing hot stream, plus the next batch's plan and payloads."""
    kw = (dict(ring_slots=4, spill_buckets=2, spill_slots=2)
          if config == "saturated" else _config_kw(config, 1))
    eng = fresh_ref_engine(R, "inc", lambda: inc_workloads(OPS)[0],
                           auditor=RefAuditor(**AUDIT_KW), **kw)
    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        eng.run_batch(ref_make_batch(*_random(rng, hi=HOT, w_prob=0.8)))
        if i >= n_batches - 2:
            eng.begin_snapshot()
    batch = ref_make_batch(*_random(rng, hi=HOT, w_prob=0.8))
    plan = ref_cc_plan(batch, eng.store.ts_counter)
    w_data, _, _ = ref_execute(plan, batch, eng.store, eng.workload)
    return eng, plan, w_data


def _plan_args(plan, w_data):
    args = (plan.w_rec, plan.w_key, plan.w_valid, plan.w_begin_ts,
            plan.w_end_ts, w_data)
    port = [_t(a) for a in args]
    port[1] = port[1].to(torch.int64)                     # uint32 -> int64
    return args, port


@pytest.mark.parametrize("config", ["spill", "saturated"])
def test_commit_versions_and_spill_commit_taps(config):
    """Ring tap ([3N] insert / victim / drop) and spill tap (placement and
    victims in input order), byte-equal, with random per-record capacity
    below K; the saturated 2 x 2 pool makes placements overwrite
    spill-resident versions."""
    eng, plan, w_data = _next_commit(config, 0)
    r = eng.store.versions.rings
    ring0 = (r.begin[0], r.end[0], r.payload[0], r.head[0])
    k_eff = np.random.default_rng(10).integers(1, 4, R).astype(np.int32)
    pins, wm, lo = eng.pin_array(), eng.watermark(), int(plan.ts_base)
    ref_args, port_args = _plan_args(plan, w_data)
    ref_out, ref_m = ref_commit_versions(
        RefRing(*ring0), *ref_args, wm, ts_window=(lo, lo + T),
        k_eff=jnp.asarray(k_eff), pin_ts=pins, with_evictees=True,
        with_audit=True)
    port_out, port_m = commit_versions(
        VersionRing(*(_t(x) for x in ring0)), *port_args, wm,
        ts_window=(lo, lo + T), k_eff=_t(k_eff), pin_ts=_t(pins),
        with_evictees=True, with_audit=True)
    assert_dicts_same(dataclass_arrays(ref_out), dataclass_arrays(port_out),
                      "ring")
    assert_dicts_same(ref_m, port_m, "ring metrics")
    assert list(ref_m) == list(port_m)
    states = np_(port_m["audit_state"])
    assert states.shape == (3 * T * OPS,)
    assert {1, 2, 3} <= set(states.tolist())

    ev = [ref_m[k] for k in ("evict_rec", "evict_begin", "evict_end",
                             "evict_payload", "evict_valid")]
    sp = eng.store.versions.spill
    pool0 = (sp.begin[0], sp.end[0], sp.rec[0], sp.payload[0])
    ref_p, ref_sm = ref_spill_commit(RefPool(*pool0), *ev, wm, pin_ts=pins,
                                     with_audit=True)
    port_p, port_sm = spill_commit(SpillPool(*(_t(x) for x in pool0)),
                                   *(_t(x) for x in ev), wm,
                                   pin_ts=_t(pins), with_audit=True)
    assert_dicts_same(dataclass_arrays(ref_p), dataclass_arrays(port_p),
                      "spill pool")
    assert_dicts_same(ref_sm, port_sm, "spill metrics")
    assert np_(port_sm["spill_audit_placed"]).any()
    if config == "saturated":
        assert np_(port_sm["spill_victim_valid"]).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_paged_tap(seed):
    """The paged tap on a slab with four spare pages: under the hot
    stream page requests fail and the dropped inserts are stamped
    PAGE_DROPPED, identically; capacities are random page multiples."""
    eng, plan, w_data = _next_commit("paged", seed)
    p = eng.store.versions.pages
    fields = (p.begin[0], p.end[0], p.payload[0], p.page_table[0],
              p.head[0])
    k_eff = 2 * np.random.default_rng(seed + 20).integers(1, 3, R).astype(
        np.int32)
    pins, wm, lo = eng.pin_array(), eng.watermark(), int(plan.ts_base)
    ref_args, port_args = _plan_args(plan, w_data)
    ref_out, ref_m = ref_pages.commit_paged(
        ref_pages.PageSlab(*fields), *ref_args, wm,
        ts_window=(lo, lo + T), k_eff=jnp.asarray(k_eff), pin_ts=pins,
        with_evictees=True, with_audit=True)
    port_out, port_m = pages.commit_paged(
        pages.PageSlab(*(_t(x) for x in fields)), *port_args, wm,
        ts_window=(lo, lo + T), k_eff=_t(k_eff), pin_ts=_t(pins),
        with_evictees=True, with_audit=True)
    assert_dicts_same(dataclass_arrays(ref_out), dataclass_arrays(port_out),
                      "slab")
    assert_dicts_same(ref_m, port_m, "paged metrics")
    assert list(ref_m) == list(port_m)
    assert int(port_m["paged_alloc_failed"]) > 0
    assert 7 in set(np_(port_m["audit_state"]).tolist())   # PAGE_DROPPED


def _drive_both(ref, port, rng, n_batches, hi=HOT, w_prob=0.8,
                pin_after=None, sweep_every=None):
    """Run the same batches through both engines; returns the pins."""
    pins = []
    for i in range(n_batches):
        arrays = _random(rng, hi=hi, w_prob=w_prob)
        ref.run_batch(_batch("ref", arrays))
        port.run_batch(_batch("port", arrays))
        if pin_after is not None and i + 1 == pin_after:
            pins.append((ref.begin_snapshot(), port.begin_snapshot()))
        if sweep_every and (i + 1) % sweep_every == 0:
            assert ref.gc_sweep() == port.gc_sweep()
    return pins


@pytest.mark.parametrize("config,n_shards", [
    ("spill", 1), ("spill", 2), ("nospill", 1), ("nospill", 2),
    ("paged", 2)])
def test_commit_sharded_audit_arrays(config, n_shards):
    """The engine's per-commit ``audit_*`` arrays (commit_sharded: global
    ids, -1 where masked), stashed unharvested, byte-equal commit by
    commit — compared before the events they become."""
    ref, port = _pair(_config_kw(config, n_shards))
    _drive_both(ref, port, np.random.default_rng(7), 5, pin_after=2)
    rp, pp = ref.auditor._pending, port.auditor._pending
    assert len(rp) == len(pp) == 5
    for i, ((rc, ra), (pc, pa)) in enumerate(zip(rp, pp)):
        assert rc == pc, i
        assert list(ra) == list(pa)
        assert_dicts_same(ra, pa, f"{config}/{n_shards} commit {i}")
        assert (np_(pa["audit_rec"]) >= 0).sum() == \
            (np_(pa["audit_state"]) > 0).sum()
    states = set(np.concatenate([np_(a["audit_state"])
                                 for _, a in pp]).tolist())
    assert AUDIT_COMMITTED in states
    if config == "spill":
        assert {4, 5} & states                       # SPILLED / DROPPED
    _assert_audits_equal(ref, port, f"{config}/{n_shards}")


@pytest.mark.parametrize("config,n_shards", [
    ("spill", 1), ("spill", 2), ("paged", 1)])
def test_gc_sharded_audited_matches_reference(config, n_shards):
    """The audited sweep's dict (delay sum/max/histogram, pin
    certification, the padded event export) and the swept store, at a
    held pin and after its release; after the release event_cap 8 is
    below the dead count, so the export truncates."""
    ref, port = _pair(_config_kw(config, n_shards))
    pins = _drive_both(ref, port, np.random.default_rng(11), 6,
                       pin_after=2)
    for release in (False, True):
        if release:
            ref.release_snapshot(pins[0][0])
            port.release_snapshot(pins[0][1])
        for cap in (8, 4096):
            wm = ref.watermark()
            ref_v, ref_n, ref_a = ref_sh.gc_sharded_audited(
                ref.store.versions, jnp.int32(wm), ref.pin_array(),
                event_cap=cap)
            port_v, port_n, port_a = gc_sharded_audited(
                port.store.versions, wm, port.pin_array(), event_cap=cap)
            msg = f"{config}/{n_shards} cap {cap} release {release}"
            assert int(ref_n) == int(port_n), msg
            assert list(ref_a) == list(port_a)
            assert_dicts_same(ref_a, port_a, msg)
            assert port_a["gc_delay_hist"].dtype == torch.int32
            # at the pin the commits' own sweeps left nothing dead;
            # the release frees more than the export holds at cap 8
            assert (int(port_a["gc_dead_total"]) > 8) == release, msg
            assert_dicts_same(
                ref_store_arrays(dataclasses.replace(ref.store,
                                                     versions=ref_v)),
                store_to_numpy(dataclasses.replace(port.store,
                                                   versions=port_v)), msg)


# ---------------------------------------------------------------------------
# 2. the auditor: conservation, pin certification, the inspector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", ["spill", "paged"])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telescope_and_gc_pin_invariant(config, n_shards, seed):
    """The reference's randomized pin/commit/sweep interleavings on both:
    events, state counts, telescope and GC report equal, mid-stream and
    after the release; on the port the telescope balances and no sweep
    reclaimed a version a registered pin could still resolve."""
    rng = np.random.default_rng(seed)
    ref, port = _pair(_config_kw(config, n_shards))
    pins = []
    for _ in range(24):
        op = rng.integers(0, 5)
        if op == 0 and len(pins) < 3:
            pins.append((ref.begin_snapshot(), port.begin_snapshot()))
        elif op == 1 and pins:
            r, p = pins.pop(int(rng.integers(len(pins))))
            ref.release_snapshot(r)
            port.release_snapshot(p)
        elif op == 2:
            assert ref.gc_sweep() == port.gc_sweep()
        else:
            arrays = _random(rng, hi=HOT)
            ref.run_batch(_batch("ref", arrays))
            port.run_batch(_batch("port", arrays))
    mid = port.auditor.telescope()
    assert mid["balanced"], mid
    _assert_audits_equal(ref, port, "mid")
    for r, p in pins:
        ref.release_snapshot(r)
        port.release_snapshot(p)
    assert ref.gc_sweep() == port.gc_sweep()
    _assert_audits_equal(ref, port, "released")

    aud = port.auditor
    t = aud.telescope()
    assert t["balanced"], t
    assert t["lhs_committed_total"] > R
    rep = aud.gc_report()
    assert rep["pin_stabbed_reclaims"] == 0
    assert sum(rep["delay_hist_log2"]) == rep["reclaimed"]
    assert 0 <= rep["delay_max"] < 2**31 - 1
    if rep["reclaimed"]:
        assert rep["delay_mean"] > 0 and rep["events_captured"] > 0
        for ev in aud.events(state=AUDIT_GC_RECLAIMED):
            assert ev.end_ts <= ev.cause_ts


def _explained(exp):
    out = dict(exp)
    if out["event"] is not None:
        out["event"] = dataclasses.astuple(out["event"])
    return out


@pytest.mark.parametrize("config", ["spill", "paged"])
def test_saturated_stream_explains_every_found_false(config):
    """Hold a pin, saturate the store, probe the pinned snapshot: reads
    equal, and ``explain_read`` of every record at the pin equal to the
    reference's; every found=False is explained by a concrete drop event
    covering the pin."""
    kw = (dict(ring_slots=4, spill_buckets=2, spill_slots=2)
          if config == "spill" else _config_kw(config, 1))
    ref, port = _pair(kw)
    rng = np.random.default_rng(3)
    _drive_both(ref, port, rng, 2)
    pin = (ref.begin_snapshot(), port.begin_snapshot())
    for i in range(8):
        arrays = _random(rng, hi=HOT, w_prob=0.8)
        ref.run_batch(_batch("ref", arrays))
        port.run_batch(_batch("port", arrays))
        if i % 3 == 2:
            assert ref.gc_sweep() == port.gc_sweep()
    ts = pin[1].ts
    r_vals, r_found = ref.snapshot_read(np.arange(R), ts=pin[0].ts)
    p_vals, p_found = port.snapshot_read(np.arange(R), ts=ts)
    np.testing.assert_array_equal(np_(r_found), np_(p_found))
    np.testing.assert_array_equal(np_(r_vals), np_(p_vals))
    found = np_(p_found)
    assert not found.all(), "stream never saturated the store"
    for r in range(R):
        want = _explained(ref.auditor.explain_read(r, ts))
        got = _explained(port.auditor.explain_read(r, ts))
        assert want == got, r
        if not found[r]:
            assert not got["found"] and got["event"] is not None, (r, got)
            assert port.auditor.explain_read(r, ts)["event"].covers(ts)
            assert got["reason"] in AUDIT_STATE_NAMES.values()
        else:
            assert got["found"] and got["reason"].startswith("resident_")
    ref.release_snapshot(pin[0])
    port.release_snapshot(pin[1])


def test_inspect_record_timeline_and_health_surface():
    """The inspector on a fresh write batch, and ``health()``'s
    ``lifecycle_*`` keys equal to the reference's."""
    ref, port = _pair(_config_kw("spill", 1))
    _drive_both(ref, port, 5, 1, hi=R, w_prob=1.0)
    ref.snapshot()
    port.snapshot()                              # harvest boundary
    aud = port.auditor
    now = port.current_ts()
    written = sorted({e.record for e in aud.events(state=AUDIT_COMMITTED)})
    assert written
    tl = port.inspect_record(written[0])
    assert tl.visible_at(now)["tier"] == "primary"
    assert tl.explain(now)["found"]
    assert any(e.state == AUDIT_COMMITTED for e in tl.events)
    want = ref.inspect_record(written[0])
    assert (want.resident, want.watermark, want.audit_events_dropped) == \
        (tl.resident, tl.watermark, tl.audit_events_dropped)
    idle = next(r for r in range(R) if r not in written)
    assert port.inspect_record(idle).explain(now)["reason"] in (
        "resident_primary", "never_written")

    rh, ph = ref.health(), port.health()
    keys = {k for k in rh if k.startswith("lifecycle_")}
    assert keys == {k for k in ph if k.startswith("lifecycle_")}
    assert len(keys) == 7
    for k in keys:
        assert rh[k] == ph[k], k
    assert ph["lifecycle_gc_pin_stabbed"] == 0
    assert ph["lifecycle_states"]["committed"] > 0
    assert ph["lifecycle_audit_events"] > 0
    snap = port.metrics.snapshot()
    assert snap["lifecycle/audit_events"] == len(aud._events)


# ---------------------------------------------------------------------------
# 3. the zero-fence contract and the inert defaults
# ---------------------------------------------------------------------------
def _service_stream(auditor, n=6):
    """Conflict-aware OOO stream + audited sweep; returns (engine, reads,
    final store)."""
    eng = BohmEngine(R, inc_workloads(OPS)[1], ring_slots=4,
                     spill_buckets=4, spill_slots=4, auditor=auditor,
                     device="cpu")
    svc = TxnService(eng, max_inflight=2, admission_window=4,
                     max_inflight_execs=2)
    tickets = svc.submit_many([_batch("port", _random(s))
                               for s in range(n)])
    reads = [np_(svc.wait(t).read_vals) for t in tickets]
    eng.gc_sweep()
    svc.drain()
    return eng, reads, store_to_numpy(eng.store)


def test_auditor_adds_zero_fences_and_results_identical(monkeypatch):
    """The auditor, off or on, adds no ``repro_torch.device.fence`` call
    and leaves reads and the final store byte-equal to an engine with no
    auditor; the ON run audited something."""
    _, want_reads, want_store = _service_stream(None)
    real = repro_torch.device.fence
    calls = {"n": 0}

    def counting(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(repro_torch.device, "fence", counting)
    fences = {}
    for name, auditor in [
            ("off", LifecycleAuditor(capacity=4, enabled=False)),
            ("on", LifecycleAuditor(**AUDIT_KW))]:
        calls["n"] = 0
        eng, reads, store = _service_stream(auditor)
        fences[name] = calls["n"]
        for w, g in zip(want_reads, reads):
            np.testing.assert_array_equal(w, g)
        assert_dicts_same(want_store, store, name)
        assert eng.auditor is auditor
    assert fences["on"] == fences["off"] >= 6
    assert auditor.events(state=AUDIT_COMMITTED)


def test_null_audit_is_inert_and_keys_never_leak():
    eng, _, _ = _service_stream(None)
    assert eng.auditor is NULL_AUDIT
    assert NULL_AUDIT.events() == []
    assert NULL_AUDIT.harvest() == 0
    m = {"audit_rec": 1}
    NULL_AUDIT.on_commit(m)
    assert m == {"audit_rec": 1}
    NULL_AUDIT.on_gc({}, 0)
    assert NULL_AUDIT.gc_sweeps == 0

    audited = BohmEngine(R, inc_workloads(OPS)[1], device="cpu",
                         auditor=LifecycleAuditor(**AUDIT_KW),
                         **_config_kw("spill", 1))
    _, metrics = audited.run_batch(_batch("port", _random(0)))
    for key in ("audit_rec", "audit_begin", "audit_end", "audit_state"):
        assert key not in metrics
    assert len(audited.auditor._pending) == 1      # stashed, not harvested


def test_inspect_requires_enabled_auditor():
    eng = BohmEngine(R, inc_workloads(OPS)[1], ring_slots=4, device="cpu")
    with pytest.raises(RuntimeError):
        eng.inspect_record(0)
    with pytest.raises(RuntimeError):
        LifecycleAuditor().telescope()
