"""MVCC health gauges: derived signals computed from store state on demand
(port of ``repro.obs.health``).

The counters and spans tell you what HAPPENED; these gauges tell you how
close the system is to its cliffs right NOW:

  watermark lag        ts_counter - watermark: how much history every
                       barrier must retain for the slowest reader;
  oldest-pin age       the stalest registered snapshot, in timestamps and
                       wall seconds;
  ring fill            per-record occupancy / k_eff percentiles — the
                       found=False early warning;
  slab / spill fill    per-shard page-slab and spill-pool saturation
                       (``repro_torch.store.store_health``);
  pressure             live-eviction count percentiles — the adaptive-K
                       policy's input distribution.

The device gauges cross to the host in one transfer per call — a
diagnostic surface that synchronises when CALLED and costs nothing when
it isn't. ``BohmEngine.health()`` and ``TxnService.health()`` are the
public entry points; ``scheduler_health`` is the serving plane's
host-only gauge dict. With an enabled lifecycle auditor the engine's
gauges add its ``lifecycle_*`` block (a harvest boundary).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.store import (ring_fill_fraction, store_health,
                               store_occupancy, to_global)


def _percentiles(x: np.ndarray, name: str, qs=(50, 90, 99)
                 ) -> Dict[str, float]:
    out = {}
    for q in qs:
        out[f"{name}_p{q}"] = float(np.percentile(x, q))
    out[f"{name}_max"] = float(x.max()) if x.size else 0.0
    return out


def engine_health(engine) -> Dict[str, object]:
    """One engine's MVCC health gauges (synchronises — diagnostic API).
    ``engine`` is a ``repro_torch.core.engine.BohmEngine``, duck-typed to
    keep the obs layer free of core imports."""
    versions = engine.store.versions
    now_ts = engine.current_ts()
    wm = engine.watermark()
    pins = sorted(s.ts for s in engine._snapshots.values())
    walls = [s.t_wall for s in engine._snapshots.values() if s.t_wall > 0]

    # one device-to-host transfer for the whole gauge tree: every gauge is
    # flattened into one float64 vector, then split on the host
    device = dict(store_health(versions))
    device["_occ"] = store_occupancy(versions)
    device["_k_eff"] = to_global(versions, versions.k_eff)
    device["_pressure"] = engine.overflow_by_record()
    flat = torch.cat([v.reshape(-1).to(torch.float64)
                      for v in device.values()]).cpu().numpy()
    host, off = {}, 0
    for k, v in device.items():
        host[k] = flat[off:off + v.numel()].reshape(tuple(v.shape)).astype(
            _numpy_dtype(v))
        off += v.numel()

    R = engine.num_records
    occ = host.pop("_occ")[:R]
    k_eff = host.pop("_k_eff")[:R]
    pressure = host.pop("_pressure")[:R]
    fill = ring_fill_fraction(torch.from_numpy(occ),
                              torch.from_numpy(k_eff)).numpy()

    health: Dict[str, object] = {
        "ts_counter": now_ts,
        "watermark": wm,
        "watermark_lag": max(0, engine._ts_next - wm),
        "active_pins": len(pins),
        "oldest_pin_ts": pins[0] if pins else None,
        "oldest_pin_lag_ts": (now_ts - pins[0]) if pins else 0,
        "oldest_pin_age_s": (round(time.monotonic() - min(walls), 6)
                             if walls else 0.0),
        "live_versions": int(occ.sum()),
        "commits_since_sweep": engine._commits_since_sweep,
    }
    health.update(_percentiles(fill, "ring_fill"))
    health.update(_percentiles(pressure.astype(np.float64), "pressure"))
    for k, v in host.items():
        health[f"{k}_by_shard"] = [round(float(x), 6) for x in v.ravel()]
    aud = getattr(engine, "auditor", None)
    if aud is not None and aud.enabled:
        # lifecycle audit plane: cumulative state counters, the GC
        # delay/pin certification, and the audit ring's own health
        gc = aud.gc_report()
        health.update({
            "lifecycle_states": aud.state_counts(),
            "lifecycle_gc_reclaimed": gc["reclaimed"],
            "lifecycle_gc_delay_mean": round(gc["delay_mean"], 3),
            "lifecycle_gc_delay_max": gc["delay_max"],
            "lifecycle_gc_pin_stabbed": gc["pin_stabbed_reclaims"],
            "lifecycle_audit_events": len(aud._events),
            "lifecycle_audit_dropped": (aud.events_dropped
                                        + aud.pending_dropped),
        })
    return health


def _numpy_dtype(t: torch.Tensor):
    """The numpy dtype a gauge tensor comes back as (float32 fractions,
    int32 counts; both are exact in float64)."""
    return np.float32 if t.is_floating_point() else np.int32


def scheduler_health(sched) -> Dict[str, object]:
    """Serving-plane gauges for a ``repro_torch.serving.BohmScheduler``
    (duck-typed): slot and page occupancy, queue depth, the Condition-3
    pending-free backlog and the prefix-cache footprint, plus the
    cumulative serving counters. Host-only state — never synchronises."""
    pending = sum(len(p) for _, p in sched.pending_free)
    return {
        "active_slots": sched.num_active,
        "slots": sched.slots,
        "slot_fill": round(sched.num_active / max(sched.slots, 1), 6),
        "queue_depth": len(sched.queue),
        "free_pages": len(sched.free_pages),
        "pages_total": sched.num_pages,
        "page_fill": round(
            1.0 - len(sched.free_pages) / max(sched.num_pages, 1), 6),
        "pending_free_pages": pending,
        "cached_pages": len(sched.cached_pages),
        "prefix_cache_entries": len(sched.prefix_cache),
        "ts_counter": sched.ts_counter,
        "admitted": sched.stats["admitted"],
        "completed": sched.stats["completed"],
        "prefix_hits": sched.stats["prefix_hits"],
        "pages_recycled": sched.stats["pages_recycled"],
    }


def service_health(service) -> Dict[str, object]:
    """Engine health plus the scheduler plane: queue depths, the admission
    window's observed occupancy and the out-of-order scheduler gauges —
    max queued-ticket age and hop saturation show a starving batch long
    before throughput does (``service`` is a
    ``repro_torch.service.TxnService``)."""
    health = engine_health(service.engine)
    now = time.monotonic()
    queued = list(service._admission)
    health.update({
        "admission_queue_depth": len(queued),
        "planned_epochs": len(service._planned),
        "inflight_epochs": len(service._inflight),
        "unclaimed_results": len(service._results),
        "admission_window": service.admission_window,
        "admission_window_occupancy_max":
            service.stats["admission_window_occupancy"],
        "scheduler_max_ticket_age_s": (
            round(max(now - a.t_admit for a in queued), 6)
            if queued else 0.0),
        "scheduler_max_queued_hops": (
            max(a.hops for a in queued) if queued else 0),
        "scheduler_hopped_batches": service.stats["hopped_batches"],
        "scheduler_class_promotions": service.stats["class_promotions"],
        "scheduler_chain_depth_max": service.stats["chain_depth_max"],
    })
    flight = getattr(service, "flight", None)
    if flight is not None and flight.enabled:
        # lazy import: obs stays free of the service layer at module
        # scope; a TxnService passed in here has loaded that module
        from repro_torch.service.txn_service import LATENCY_CLASSES
        names = {rank: name for name, rank in LATENCY_CLASSES.items()}
        slo = {}
        for rank, row in flight.class_quantiles().items():
            name = names.get(rank, f"class_{rank}")
            slo[name] = {
                "p50_ms": round(row["p50"] * 1e3, 4),
                "p99_ms": round(row["p99"] * 1e3, 4),
                "mean_ms": round(row["mean"] * 1e3, 4),
                "count": row["count"],
            }
        health.update({
            "flight_slo": slo,
            "flight_completed": flight.completed,
            "flight_inflight": flight.inflight(),
            "flight_dropped": flight.dropped,
            "flight_blocking_records": flight.blocking_top(),
            "flight_block_kinds": dict(flight.block_kinds),
        })
    return health
