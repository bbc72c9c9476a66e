"""Continuous MVCC health monitor: sampled gauges -> series -> alerts
(port of ``repro.obs.monitor``, host code only).

``repro_torch.obs.health`` computes the gauge tree on demand; this module adds
the TIME axis. A ``HealthMonitor`` wraps any object with a ``health()``
method (``BohmEngine`` or ``TxnService``, duck-typed) and, at a fixed
cadence, folds one ``health()`` sample into:

``bounded ring-buffer series``  one ``deque(maxlen=capacity)`` of
    (t_wall, value) per watched gauge — a long-running service keeps the
    most recent window and counts what it dropped.

``EWMA anomaly detectors``      one ``repro_torch.obs.ewma.EwmaAnomaly`` per
    gauge (the same estimator the tracer and the straggler detector
    use): a sample exceeding ``threshold`` x its own baseline raises a
    ``warn`` alert, ``2 x threshold`` raises ``crit``; flagged samples
    never contaminate the baseline.

``a severity-tagged event log``  in memory (bounded) and optionally as
    append-only JSONL (``log_path``) — one line per alert with the
    gauge, value, baseline and severity.

The watched gauges are the MVCC cliff signals: watermark lag, oldest
pin age/lag, ring-fill p99, slab/spill saturation (max over shards),
flight p99 and the admission queue depth — keys absent from a target's
health dict (no spill tier, no scheduler) are simply skipped.

Sampling honors the telemetry contract by CONSTRUCTION rather than by
laziness: ``health()`` synchronises, so the monitor only runs where the
caller already stands at a boundary — ``tick()`` from a serving loop, a
benchmark epoch, or a drain. The hot path never sees the monitor.

Export: ``to_counter_events`` renders every series as Chrome
``trace_event`` counter tracks (``ph: "C"``), stitched onto the shared
time origin by ``repro_torch.obs.flight.stitch_chrome_trace(..., monitor=)``
so gauge trajectories plot UNDER the phase spans and ticket lanes in
Perfetto.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.obs.ewma import EwmaAnomaly

_US = 1e6

#: default watched gauges: (health key, scale threshold) — None means use
#: the monitor-wide threshold. Keys are matched against the target's
#: ``health()`` dict after derivation (``*_max`` reduces the per-shard
#: lists; ``flight_p99_ms`` reduces the per-class SLO table).
DEFAULT_WATCH = (
    "watermark_lag",
    "oldest_pin_lag_ts",
    "oldest_pin_age_s",
    "ring_fill_p99",
    "live_versions",
    "slab_fill_max",
    "spill_fill_max",
    "flight_p99_ms",
    "admission_queue_depth",
)


def _derive(health: Dict) -> Dict[str, float]:
    """Flatten one health() sample into scalar gauges: per-shard lists
    reduce to their max (the cliff is the WORST shard), the flight SLO
    table to the worst per-class p99."""
    out: Dict[str, float] = {}
    for k, v in health.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = float(v)
        elif isinstance(v, list) and k.endswith("_by_shard") and v:
            if all(isinstance(x, (int, float)) for x in v):
                out[k[: -len("_by_shard")] + "_max"] = float(max(v))
    slo = health.get("flight_slo")
    if isinstance(slo, dict) and slo:
        p99s = [row.get("p99_ms", 0.0) for row in slo.values()
                if isinstance(row, dict)]
        if p99s:
            out["flight_p99_ms"] = float(max(p99s))
    return out


class HealthMonitor:
    """Fixed-cadence health sampler with EWMA alerting (see module doc).

    ``cadence_s=0`` samples on every ``tick()`` — the benchmark/test
    mode; a serving loop passes its scrape interval. ``watch=None``
    tracks ``DEFAULT_WATCH`` (absent keys skipped); pass an explicit
    tuple to narrow or extend. ``enabled=False`` turns every hook into
    a no-op (the NULL_FLIGHT pattern) so callers can carry a monitor
    unconditionally.
    """

    def __init__(self, target, cadence_s: float = 0.0,
                 capacity: int = 1024, alpha: float = 0.2,
                 threshold: float = 3.0,
                 watch: Optional[Tuple[str, ...]] = None,
                 log_path: Optional[str] = None,
                 event_capacity: int = 1024,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be positive")
        self.target = target
        self.cadence_s = float(cadence_s)
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.watch = tuple(watch) if watch is not None else DEFAULT_WATCH
        self.log_path = log_path
        self.enabled = enabled
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}
        self._detectors: Dict[str, EwmaAnomaly] = {}
        self._events: Deque[Dict] = deque(maxlen=int(event_capacity))
        self._clock = time.perf_counter
        self._last_sample: Optional[float] = None
        self.samples = 0
        self.dropped = 0
        self.alerts: Dict[str, int] = {}

    # -- sampling ----------------------------------------------------------
    def tick(self) -> Optional[Dict[str, float]]:
        """Sample iff the cadence elapsed since the last sample (always,
        when ``cadence_s == 0``). Returns the gauge dict sampled, or
        None when the monitor is off cadence / disabled."""
        if not self.enabled:
            return None
        now = self._clock()
        if (self._last_sample is not None
                and now - self._last_sample < self.cadence_s):
            return None
        return self.sample()

    def sample(self) -> Dict[str, float]:
        """Unconditionally fold one ``target.health()`` sample into the
        series and detectors (synchronises — call at boundaries only)."""
        if not self.enabled:
            return {}
        gauges = _derive(self.target.health())
        t = self._clock()
        self._last_sample = t
        self.samples += 1
        taken = {}
        for key in self.watch:
            if key not in gauges:
                continue
            value = gauges[key]
            taken[key] = value
            dq = self._series.get(key)
            if dq is None:
                dq = self._series[key] = deque(maxlen=self.capacity)
            if len(dq) == self.capacity:
                self.dropped += 1
            dq.append((t, value))
            self._detect(key, value, t)
        return taken

    def _detect(self, key: str, value: float, t: float) -> None:
        det = self._detectors.get(key)
        if det is None:
            det = self._detectors[key] = EwmaAnomaly(
                self.alpha, self.threshold)
        baseline = det.baseline
        if det.record(value):
            # beyond 2x the warn bar the gauge is not drifting, it is
            # cliff-diving — tag it so alert routing can differ
            severity = ("crit" if value > 2 * self.threshold * baseline
                        else "warn")
            self.alerts[key] = self.alerts.get(key, 0) + 1
            event = {"t": round(t, 6), "gauge": key,
                     "value": round(value, 6),
                     "baseline": round(baseline, 6),
                     "threshold": self.threshold,
                     "severity": severity}
            self._events.append(event)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(event) + "\n")

    # -- views -------------------------------------------------------------
    def series(self, key: str) -> List[Tuple[float, float]]:
        return list(self._series.get(key, ()))

    def keys(self) -> List[str]:
        return sorted(self._series)

    def latest(self) -> Dict[str, float]:
        return {k: dq[-1][1] for k, dq in self._series.items() if dq}

    def baselines(self) -> Dict[str, Optional[float]]:
        return {k: d.baseline for k, d in self._detectors.items()}

    def events(self, severity: Optional[str] = None) -> List[Dict]:
        return [e for e in self._events
                if severity is None or e["severity"] == severity]

    # -- export ------------------------------------------------------------
    def earliest_ts(self) -> Optional[float]:
        stamps = [dq[0][0] for dq in self._series.values() if dq]
        return min(stamps) if stamps else None

    def to_counter_events(self, t0: float, pid: int = 0) -> List[Dict]:
        """Chrome counter-track events (``ph: "C"``), one per retained
        sample per gauge — Perfetto renders each name as a stacked
        counter plot. Timestamps are microseconds since ``t0`` (the
        caller's shared epoch)."""
        events: List[Dict] = []
        for key in self.keys():
            for t, v in self._series[key]:
                events.append({
                    "name": f"health/{key}", "ph": "C",
                    "ts": round((t - t0) * _US, 3),
                    "pid": pid, "tid": 0, "args": {key: v}})
        events.sort(key=lambda e: e["ts"])
        return events


#: shared disabled monitor — every hook is one attribute test
NULL_MONITOR = HealthMonitor(target=None, capacity=1, enabled=False)
