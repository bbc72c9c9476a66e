"""Version-lifecycle auditor: the storage X-ray (port of
``repro.obs.lifecycle``).

Every version transition the store already executes — committed,
overwritten-live, overwritten-dead, spilled, spill-dropped,
spill-overwritten, page-dropped, gc-reclaimed — feeds two sinks:

``per-state device counters``  lazy ``registry.accumulate`` folds of the
    scalar counters the commit already returns (plus ``ring_committed``
    and the GC-audit tallies), under the ``lifecycle/`` namespace. Their
    sums telescope: every committed version is eventually accounted for
    by exactly one terminal disposition or is still resident
    (``telescope()`` checks the identity).

``a bounded host audit ring``  of (record, begin_ts, end_ts, state,
    cause_ts) events. The commit emits fixed-shape ``audit_*`` tensors
    when the engine commits with ``with_audit=True`` (see
    ``repro_torch.store.sharded.commit_sharded``); ``on_commit`` only
    *stashes* them, and ``harvest()`` — called at ``gc_sweep`` /
    ``snapshot()`` / drain boundaries — concatenates every stashed
    tensor on the device and copies them to the host in ONE transfer.
    Nothing in the hot path joins the host: the fence count is the same
    with the auditor on as off (``tests/test_torch_lifecycle.py``).

From the ring, ``inspect_record(r)`` reconstructs a record's version
timeline across ring/spill/slab: which version was visible at ts t, and
when found=False, *which* drop event explains it. The GC audit
(``gc_sharded_audited``) adds the death->reclamation delay distribution
and a per-sweep certification that no reclaimed version was stabbable by
a registered pin (``gc_report()["pin_stabbed_reclaims"] == 0``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.store.ring import (AUDIT_COMMITTED, AUDIT_GC_RECLAIMED,
                                    AUDIT_OVERWROTE_DEAD,
                                    AUDIT_OVERWROTE_LIVE,
                                    AUDIT_PAGE_DROPPED, AUDIT_SPILL_DROPPED,
                                    AUDIT_SPILL_OVERWROTE, AUDIT_SPILLED,
                                    AUDIT_STATE_NAMES, INF_TS)

__all__ = [
    "AuditEvent", "LifecycleAuditor", "NULL_AUDIT", "RecordTimeline",
    "AUDIT_COMMITTED", "AUDIT_OVERWROTE_LIVE", "AUDIT_OVERWROTE_DEAD",
    "AUDIT_SPILLED", "AUDIT_SPILL_DROPPED", "AUDIT_SPILL_OVERWROTE",
    "AUDIT_PAGE_DROPPED", "AUDIT_GC_RECLAIMED", "AUDIT_STATE_NAMES",
]

# states that terminate a version's visibility — the ones that can
# *explain* a found=False read inside the version's [begin, end) window
_DROP_STATES = frozenset({
    AUDIT_OVERWROTE_LIVE, AUDIT_OVERWROTE_DEAD, AUDIT_SPILL_DROPPED,
    AUDIT_SPILL_OVERWROTE, AUDIT_PAGE_DROPPED, AUDIT_GC_RECLAIMED,
})

# registry counter name -> commit-metrics key (accumulated lazily per
# commit; keys absent from a configuration are skipped)
_COMMIT_COUNTERS = (
    ("lifecycle/committed", "ring_committed"),
    ("lifecycle/overwritten_live", "ring_overwrote_live"),
    ("lifecycle/overwritten_dead", "ring_overwrote_dead"),
    ("lifecycle/page_dropped", "paged_alloc_failed"),
    ("lifecycle/gc_commit_reclaimed", "ring_evicted"),
    ("lifecycle/spilled", "spill_admitted"),
    ("lifecycle/spill_dropped", "spill_dropped"),
    ("lifecycle/spill_overwritten", "spill_overwrote"),
    ("lifecycle/gc_spill_reclaimed", "spill_freed"),
)

_GC_COUNTERS = ("lifecycle/gc_sweep_reclaimed", "lifecycle/gc_delay_sum",
                "lifecycle/gc_pin_stabbed", "lifecycle/gc_delay_hist")

_AUDIT_KEYS = ("audit_rec", "audit_begin", "audit_end", "audit_state")
_GC_EVENT_KEYS = ("gc_event_rec", "gc_event_begin", "gc_event_end")


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy tensors to the host in ONE transfer: flatten and concatenate
    them on their device (as int64, exact for every int32 value), copy
    once, and split on the host back into their shapes."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    host = flat.cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[off:off + n].reshape(tuple(t.shape)))
        off += n
    return out


@dataclasses.dataclass(frozen=True)
class AuditEvent:
    """One version transition: record ``record``'s version [begin_ts,
    end_ts) entered ``state`` because of the commit/sweep at
    ``cause_ts``."""
    record: int
    begin_ts: int
    end_ts: int
    state: int
    cause_ts: int

    @property
    def state_name(self) -> str:
        return AUDIT_STATE_NAMES.get(self.state, f"state{self.state}")

    def covers(self, ts: int) -> bool:
        """Would this version have been visible at snapshot ``ts``?"""
        return self.begin_ts <= ts < self.end_ts


@dataclasses.dataclass
class RecordTimeline:
    """``inspect_record``'s answer: the versions of one record still
    resident in the store (primary + spill) plus every harvested audit
    event that touched it, newest last."""
    record: int
    resident: List[Dict]          # {begin, end, tier: "primary"|"spill"}
    events: List[AuditEvent]
    watermark: int
    audit_events_dropped: int     # ring overflow: timeline may be partial

    def visible_at(self, ts: int) -> Optional[Dict]:
        """The resident version a snapshot read at ``ts`` resolves to
        (None -> the store answers found=False)."""
        for v in self.resident:
            if v["begin"] <= ts < v["end"]:
                return v
        return None

    def explain(self, ts: int) -> Dict:
        """Explain a snapshot read of this record at ``ts``: either the
        resident version it resolves to, or the concrete drop event that
        destroyed the version which WOULD have been visible."""
        v = self.visible_at(ts)
        if v is not None:
            return {"found": True, "reason": f"resident_{v['tier']}",
                    "version": v, "event": None}
        # newest cause first: a version may be overwritten-live, then
        # spilled, then spill-overwritten — the LAST covering drop event
        # is its final disposition
        for ev in reversed(self.events):
            if ev.state in _DROP_STATES and ev.covers(ts):
                return {"found": False, "reason": ev.state_name,
                        "event": ev}
        if ts < self.watermark:
            # reclaimed below the watermark by a commit-internal sweep
            # (which emits no per-version events): legal, no active or
            # future reader can hold a snapshot there
            return {"found": False, "reason": "below_gc_watermark",
                    "event": None}
        if self.audit_events_dropped:
            return {"found": False, "reason": "audit_ring_overflow",
                    "event": None}
        return {"found": False, "reason": "never_written", "event": None}


class LifecycleAuditor:
    """Bounded, zero-fence version-lifecycle audit (see module doc).

    ``enabled=False`` (the shared ``NULL_AUDIT``) turns every hook into
    a no-op so the engine carries the auditor unconditionally. Knobs:
    ``capacity`` bounds the host audit ring, ``pending_cap`` bounds the
    un-harvested stash (oldest commits drop first, counted),
    ``per_record_cap`` bounds each record's timeline index, and
    ``gc_event_cap`` is the per-sweep reclaim-event export width.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True,
                 pending_cap: int = 128, per_record_cap: int = 64,
                 gc_event_cap: int = 256):
        self.enabled = enabled
        self.capacity = int(capacity)
        self.pending_cap = int(pending_cap)
        self.gc_event_cap = int(gc_event_cap)
        self._per_record_cap = int(per_record_cap)
        self._pending: List = []       # (cause_ts, {audit_* tensors})
        self._pending_gc: List = []    # (watermark, {gc_* tensors})
        self.pending_dropped = 0
        self._events: Deque[AuditEvent] = deque(maxlen=self.capacity)
        self.events_dropped = 0
        self._by_record: Dict[int, Deque[AuditEvent]] = {}
        self._by_record_dropped: Dict[int, int] = {}
        self.gc_sweeps = 0
        self._engine = None
        self._registry = None

    # -- wiring ------------------------------------------------------------
    def bind_engine(self, engine) -> None:
        self._engine = engine
        self.bind_registry(engine.metrics, device=engine.device)

    def bind_registry(self, registry, device: DeviceLike = None) -> None:
        """Declare the ``lifecycle/`` device counters on ``device`` (the
        bound engine's; default the card) and register the
        snapshot-boundary gauges (evaluating them IS a harvest point:
        ``registry.snapshot()`` realises the pending stash)."""
        self._registry = registry
        z = torch.zeros((), dtype=torch.int32,
                        device=resolve_device(device))
        for name, _ in _COMMIT_COUNTERS:
            registry.declare(name, z)
        for name in _GC_COUNTERS[:-1]:
            registry.declare(name, z)
        registry.declare("lifecycle/gc_delay_hist",
                         torch.zeros((16,), dtype=torch.int32,
                                     device=z.device))
        registry.register_gauge(
            "lifecycle/audit_events",
            lambda: (self.harvest(), len(self._events))[1])
        registry.register_gauge("lifecycle/audit_dropped",
                                lambda: self.events_dropped)
        registry.register_gauge("lifecycle/gc_sweeps",
                                lambda: self.gc_sweeps)

    # -- hot-path hooks (lazy: no sync, no fence) --------------------------
    def on_commit(self, metrics: Dict,
                  cause_ts: Optional[int] = None) -> None:
        """Fold one commit's metrics into the state counters and stash
        its ``audit_*`` tensors (popped from ``metrics`` so result
        fan-out never carries them). Host cost: dict ops only; the cause
        ts comes from the engine's host mirror, never from a tensor."""
        if not self.enabled:
            return
        reg = self._registry
        if reg is not None:
            for name, key in _COMMIT_COUNTERS:
                if key in metrics:
                    reg.accumulate(name, metrics[key])
        arrays = {k: metrics.pop(k) for k in _AUDIT_KEYS if k in metrics}
        if not arrays:
            return
        if cause_ts is None and self._engine is not None:
            cause_ts = int(getattr(self._engine, "_ts_next", 0))
        if len(self._pending) >= self.pending_cap:
            self._pending.pop(0)
            self.pending_dropped += 1
        self._pending.append((int(cause_ts or 0), arrays))

    def on_gc(self, audit: Dict, watermark: int) -> None:
        """Fold one audited sweep's tallies (lazy device adds) and stash
        its reclaim-event tensors for the next harvest."""
        if not self.enabled:
            return
        self.gc_sweeps += 1
        reg = self._registry
        if reg is not None:
            reg.accumulate("lifecycle/gc_sweep_reclaimed",
                           audit["gc_dead_total"])
            reg.accumulate("lifecycle/gc_delay_sum", audit["gc_delay_sum"])
            reg.accumulate("lifecycle/gc_delay_hist",
                           audit["gc_delay_hist"])
            reg.accumulate("lifecycle/gc_pin_stabbed",
                           audit["gc_pin_stabbed"])
            reg.accumulate_max("lifecycle/gc_delay_max",
                               audit["gc_delay_max"])
        if len(self._pending_gc) >= self.pending_cap:
            self._pending_gc.pop(0)
            self.pending_dropped += 1
        self._pending_gc.append((int(watermark), audit))

    # -- the boundary transfer ---------------------------------------------
    def harvest(self) -> int:
        """Copy every stashed commit/sweep to the host in ONE transfer and
        append its events to the audit ring. Called at ``gc_sweep``,
        ``snapshot()`` and drain boundaries (and before any inspection),
        never from the hot path. Returns the number of events added."""
        if not self.enabled or not (self._pending or self._pending_gc):
            return 0
        pend, self._pending = self._pending, []
        pend_gc, self._pending_gc = self._pending_gc, []
        host = iter(_to_host(
            [a[k] for _, a in pend for k in _AUDIT_KEYS]
            + [a[k] for _, a in pend_gc for k in _GC_EVENT_KEYS]))
        n_new = 0
        for cause, _ in pend:
            rec, beg, end, state = (next(host) for _ in _AUDIT_KEYS)
            idx = np.nonzero(state > 0)[0]
            for r, b, e, s in zip(rec[idx].tolist(), beg[idx].tolist(),
                                  end[idx].tolist(), state[idx].tolist()):
                self._push(AuditEvent(r, b, e, s, cause))
            n_new += idx.size
        for wm, _ in pend_gc:
            rec, beg, end = (next(host) for _ in _GC_EVENT_KEYS)
            idx = np.nonzero(rec >= 0)[0]
            for r, b, e in zip(rec[idx].tolist(), beg[idx].tolist(),
                               end[idx].tolist()):
                self._push(AuditEvent(r, b, e, AUDIT_GC_RECLAIMED, wm))
            n_new += idx.size
        return n_new

    def _push(self, ev: AuditEvent) -> None:
        if len(self._events) == self.capacity:
            self.events_dropped += 1
        self._events.append(ev)
        dq = self._by_record.get(ev.record)
        if dq is None:
            dq = self._by_record[ev.record] = deque(
                maxlen=self._per_record_cap)
        if len(dq) == self._per_record_cap:
            # a hot record outran its timeline index: count it so
            # ``explain`` reports overflow instead of "never_written"
            self._by_record_dropped[ev.record] = \
                self._by_record_dropped.get(ev.record, 0) + 1
        dq.append(ev)

    # -- inspection --------------------------------------------------------
    def events(self, state: Optional[int] = None,
               record: Optional[int] = None) -> List[AuditEvent]:
        self.harvest()
        src = (self._by_record.get(record, ()) if record is not None
               else self._events)
        return [e for e in src if state is None or e.state == state]

    def inspect_record(self, record: int) -> RecordTimeline:
        """The time-travel inspector: the record's resident versions
        (primary ring/slab + spill bucket, one transfer) merged with its
        harvested audit events. Diagnostic path: synchronises."""
        if self._engine is None:
            raise RuntimeError("auditor is not bound to an engine")
        self.harvest()
        eng = self._engine
        vs = eng.store.versions
        n = vs.n_shards
        begin, end = eng.snapshot_windows([record])[:2]
        lazy = [begin[0], end[0]]
        loc = record // n
        if vs.spill is not None:
            from repro_torch.store import spill_bucket
            lazy += list(spill_bucket(vs, record))
        host = _to_host(lazy)
        resident = [
            {"begin": int(b), "end": int(e), "tier": "primary"}
            for b, e in zip(host[0].tolist(), host[1].tolist())
            if b != INF_TS]
        if vs.spill is not None:
            s_rec, s_beg, s_end = host[2:]
            resident += [
                {"begin": int(b), "end": int(e), "tier": "spill"}
                for r, b, e in zip(s_rec.tolist(), s_beg.tolist(),
                                   s_end.tolist()) if r == loc]
        resident.sort(key=lambda v: v["begin"])
        return RecordTimeline(
            record=record, resident=resident,
            events=list(self._by_record.get(record, ())),
            watermark=int(eng.watermark()),
            audit_events_dropped=(
                self.events_dropped + self.pending_dropped
                + self._by_record_dropped.get(record, 0)))

    def explain_read(self, record: int, ts: int) -> Dict:
        """One-shot ``inspect_record(record).explain(ts)``."""
        return self.inspect_record(record).explain(ts)

    # -- aggregate views ---------------------------------------------------
    def _counter_values(self, extra: Optional[Dict] = None
                        ) -> Dict[str, object]:
        """Every ``lifecycle/`` device counter (and the ``extra`` device
        tensors) in one transfer: 0-d counters as numpy int64 scalars,
        the histogram as an int64 array."""
        reg = self._registry
        lazy: Dict[str, torch.Tensor] = {}
        if reg is not None:
            names = [n for n, _ in _COMMIT_COUNTERS] + list(_GC_COUNTERS) \
                + ["lifecycle/gc_delay_max"]
            for name in names:
                try:
                    lazy[name] = reg.peek(name)
                except KeyError:
                    pass
        lazy.update(extra or {})
        keys = sorted(lazy)        # the reference's device_get key order
        host = _to_host([lazy[k] for k in keys])
        return {k: (v[()] if v.ndim == 0 else v)
                for k, v in zip(keys, host)}

    def state_counts(self) -> Dict[str, int]:
        """Cumulative per-state transition counts (host ints)."""
        self.harvest()
        return self._state_counts(self._counter_values())

    def _state_counts(self, vals: Dict[str, object]) -> Dict[str, int]:
        out = {name.split("/", 1)[1]: int(v) for name, v in vals.items()
               if name.startswith("lifecycle/") and np.ndim(v) == 0}
        if self._engine is not None:
            out["initial"] = int(self._engine.num_records)
        return out

    def telescope(self) -> Dict[str, object]:
        """The conservation identity: every version ever committed
        (including each real record's initial version) is accounted for
        by exactly one terminal disposition or is still resident.

            initial + committed ==
              overwritten_dead + gc_commit + gc_spill + gc_sweep
              + resident_primary
              + (spill attached: spill_dropped + spill_overwritten
                                 + resident_spill
                 else:           overwritten_live)

        The residents and the counters cross in one transfer."""
        if self._engine is None:
            raise RuntimeError("auditor is not bound to an engine")
        self.harvest()
        vs = self._engine.store.versions
        from repro_torch.store import store_occupancy, sum_over_shards
        extra = {"resident_primary": store_occupancy(vs).sum()}
        if vs.spill is not None:
            extra["resident_spill"] = sum_over_shards(
                lambda rec: (rec >= 0).sum(), vs.spill.rec)
        vals = self._counter_values(extra)
        resident = {k: int(vals.pop(k)) for k in extra}
        c = self._state_counts(vals)
        with_spill = "resident_spill" in resident
        lhs = c.get("initial", 0) + c.get("committed", 0)
        rhs = (c.get("overwritten_dead", 0)
               + c.get("gc_commit_reclaimed", 0)
               + c.get("gc_spill_reclaimed", 0)
               + c.get("gc_sweep_reclaimed", 0)
               + resident["resident_primary"])
        if with_spill:
            rhs += (c.get("spill_dropped", 0)
                    + c.get("spill_overwritten", 0)
                    + resident["resident_spill"])
        else:
            rhs += c.get("overwritten_live", 0)
        return {"lhs_committed_total": lhs, "rhs_disposed_total": rhs,
                "balanced": lhs == rhs, "counts": c,
                "resident": resident}

    def gc_report(self) -> Dict[str, object]:
        """The death->reclamation delay distribution plus the pin
        certification, aggregated over every audited sweep."""
        self.harvest()
        vals = self._counter_values()
        count = int(vals.get("lifecycle/gc_sweep_reclaimed", 0))
        delay_sum = int(vals.get("lifecycle/gc_delay_sum", 0))
        hist = np.asarray(
            vals.get("lifecycle/gc_delay_hist", np.zeros(16, np.int32)))
        delay_max = int(vals.get("lifecycle/gc_delay_max", 0))
        return {
            "sweeps": self.gc_sweeps,
            "reclaimed": count,
            "delay_sum": delay_sum,
            "delay_mean": delay_sum / count if count else 0.0,
            "delay_max": delay_max,
            "delay_hist_log2": [int(x) for x in hist],
            "pin_stabbed_reclaims": int(
                vals.get("lifecycle/gc_pin_stabbed", 0)),
            "events_captured": sum(
                1 for e in self._events
                if e.state == AUDIT_GC_RECLAIMED),
        }


# the shared disabled instance engines default to: every hook is an
# ``enabled`` check and nothing else (the NULL_FLIGHT pattern)
NULL_AUDIT = LifecycleAuditor(capacity=1, enabled=False)
