"""Phase tracing: bounded span ring + Chrome ``trace_event`` export (port
of ``repro.obs.trace``).

Span instrumentation around the engine's phase graph (plan / exec /
commit), the scheduler's admission decisions, ``gc_sweep`` and
``reassign_k``, recorded into a bounded in-memory event ring with
wall-clock timing.

CUDA work is asynchronous, so a span that only timed the Python call
would measure the launch queue, not the phase. A span therefore takes a
**fence**: the value (a tensor, or a dataclass / tuple / dict holding
tensors) whose realisation marks the phase's end. ``sp.fence(x)``
registers it; span close calls ``repro_torch.device.fence`` on it and
stamps the end time after it. That wait is the entire cost of tracing,
and it happens ONLY when tracing is enabled:

  * ``tracer.span(...)`` with ``enabled=False`` returns the shared no-op
    ``NULL_SPAN``: no timestamps, no event, no fence (the tests count
    ``repro_torch.device.fence`` calls);
  * ``instant(...)`` with ``enabled=False`` is one attribute test.

As in the reference, a span waits at its close only, never at its open.
Back-to-back fenced spans (plan -> exec -> commit) therefore each open
on an idle stream; a span opened behind unfenced queued work also
times that work.

Events live in a ``deque(maxlen=capacity)`` ring: a long-running
service keeps the most recent window and counts what it dropped.
Export is Chrome ``trace_event`` JSON (the ``{"traceEvents": [...]}``
object format): B/E pairs per (pid, tid) plus thread-scoped instants,
loadable in Perfetto / ``chrome://tracing``. ``validate_chrome_trace``
checks the invariants every exported artifact is held to (B/E LIFO
matching, monotonic timestamps, async lanes, counter args).

``annotate=True`` also opens a ``torch.profiler.record_function`` range
per span, so spans show up inside a ``torch.profiler`` capture.

Per-name EWMA anomaly baselines (``repro_torch.obs.ewma.EwmaAnomaly``)
flag spans whose duration exceeds ``anomaly_threshold`` x their own
baseline; flagged spans carry ``"anomaly": true`` in their E-event args
and are counted in ``tracer.anomalies``.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.obs.ewma import EwmaAnomaly

_US = 1e6


class _NullSpan:
    """Shared no-op span — the entire disabled-tracing hot path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, x):
        return x

    def note(self, **kw):
        pass


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_fence", "_ann",
                 "_notes")

    def __init__(self, tracer: "PhaseTracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._fence = None
        self._ann = None
        self._notes: Optional[Dict] = None

    def fence(self, x):
        """Register the device value whose realisation ends this span
        (returned unchanged, so call sites stay expression-shaped)."""
        self._fence = x
        return x

    def note(self, **kw):
        """Attach result attributes discovered inside the span (policy
        grants, reclaim counts, ...): they land in the E-event args."""
        if self._notes is None:
            self._notes = {}
        self._notes.update(kw)

    def __enter__(self):
        tr = self._tracer
        if tr.annotate:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = tr._clock()
        tr._push("B", self.name, self._t0, self.args)
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        if self._fence is not None:
            device_mod.fence(self._fence)
        if self._ann is not None:
            self._ann.__exit__(*exc)
        t1 = tr._clock()
        dt = t1 - self._t0
        args: Dict = {"dur_ms": round(dt * 1e3, 4)}
        if self._notes:
            args.update(self._notes)
        if tr._flag_anomaly(self.name, dt):
            args["anomaly"] = True
        tr._push("E", self.name, t1, args)
        return False


class PhaseTracer:
    def __init__(self, capacity: int = 8192, enabled: bool = False,
                 annotate: bool = False,
                 anomaly_alpha: float = 0.1,
                 anomaly_threshold: Optional[float] = None):
        if capacity < 2:
            raise ValueError("capacity must hold at least one B/E pair")
        self.enabled = enabled
        self.annotate = annotate
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._clock = time.perf_counter
        self._t0: Optional[float] = None
        self.dropped = 0
        self._anomaly_alpha = anomaly_alpha
        self._anomaly_threshold = anomaly_threshold
        self._baselines: Dict[str, EwmaAnomaly] = {}
        self.anomalies: Dict[str, int] = {}

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager for one phase span. Disabled tracing returns
        the shared no-op span (no fence at exit)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Thread-scoped instant event (admission decisions etc.)."""
        if not self.enabled:
            return
        self._push("i", name, self._clock(), args)

    def _push(self, ph: str, name: str, t: float, args: Dict) -> None:
        if self._t0 is None:
            self._t0 = t
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append((ph, name, t, args))

    def _flag_anomaly(self, name: str, dt: float) -> bool:
        if self._anomaly_threshold is None:
            return False
        det = self._baselines.get(name)
        if det is None:
            det = self._baselines[name] = EwmaAnomaly(
                self._anomaly_alpha, self._anomaly_threshold)
        if det.record(dt):
            self.anomalies[name] = self.anomalies.get(name, 0) + 1
            return True
        return False

    def clear(self) -> None:
        self._events.clear()
        self._t0 = None
        self.dropped = 0

    # -- export ------------------------------------------------------------
    def events(self) -> List[tuple]:
        """The ring as (ph, name, host seconds, args) tuples."""
        return list(self._events)

    def instants(self) -> List[Tuple[str, float, Dict]]:
        """The ring's instants as (name, host seconds, args)."""
        return [(name, t, args) for ph, name, t, args in self._events
                if ph == "i"]

    def span_durations(self) -> Dict[str, List[float]]:
        """Per-name closed-span wall durations (seconds), B/E matched in
        ring order. Spans whose B fell out of the bounded ring are
        skipped."""
        out: Dict[str, List[float]] = {}
        open_ts: Dict[str, List[float]] = {}
        for ph, name, t, _ in self._events:
            if ph == "B":
                open_ts.setdefault(name, []).append(t)
            elif ph == "E" and open_ts.get(name):
                t0 = open_ts[name].pop()
                out.setdefault(name, []).append(t - t0)
        return out

    def to_chrome_trace(self, t0: Optional[float] = None) -> Dict:
        """Chrome ``trace_event`` object-format dict: B/E duration events
        + thread-scoped instants, timestamps in microseconds since the
        first recorded event. ``t0`` (perf_counter seconds) pins a shared
        time origin when stitching with other event sources
        (``repro_torch.obs.flight.stitch_chrome_trace``); it must not
        exceed the first recorded stamp."""
        if t0 is None:
            t0 = self._t0 or 0.0
        pid, tid = os.getpid(), 1
        events = []
        depth = 0           # ring overflow drops oldest-first, which can
        #                     orphan an E at the head: skip those so the
        #                     export always carries well-formed B/E pairs
        for ph, name, t, args in self._events:
            if ph == "B":
                depth += 1
            elif ph == "E":
                if depth == 0:
                    continue
                depth -= 1
            ev = {"name": name, "ph": ph, "ts": round((t - t0) * _US, 3),
                  "pid": pid, "tid": tid, "cat": "mvcc"}
            if ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)


def validate_chrome_trace(trace: Dict) -> Dict[str, int]:
    """Validate a Chrome ``trace_event`` object-format dict: every event
    carries name/ph/ts/pid/tid, timestamps are monotonic non-decreasing
    in record order, and B/E events match LIFO per (pid, tid) with no
    unmatched E and no dangling B. Nestable async events (ph b/n/e, the
    flight recorder's per-ticket lanes) must also carry ``id`` and
    ``cat``, and b/e match LIFO per (pid, cat, id). Counter events (ph C,
    the health monitor's gauge tracks) must carry non-empty ``args``.
    Returns summary counts; raises ``ValueError`` on the first
    violation."""
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    stacks: Dict[tuple, List[str]] = {}
    async_stacks: Dict[tuple, List[str]] = {}
    last_ts = None
    n_spans = n_instants = n_async = n_counters = 0
    async_lanes = set()
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing '{field}'")
        ph, ts = ev["ph"], ev["ts"]
        if last_ts is not None and ts < last_ts:
            raise ValueError(f"event {i} ts {ts} < previous {last_ts}")
        last_ts = ts
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: E without open B")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(
                    f"event {i}: E '{ev['name']}' closes B '{top}'")
            n_spans += 1
        elif ph == "i":
            n_instants += 1
        elif ph == "C":
            if not ev.get("args"):
                raise ValueError(f"event {i}: counter 'C' without args")
            n_counters += 1
        elif ph in ("b", "n", "e"):
            for field in ("id", "cat"):
                if field not in ev:
                    raise ValueError(
                        f"event {i}: async '{ph}' missing '{field}'")
            akey = (ev["pid"], ev["cat"], ev["id"])
            async_lanes.add(akey)
            if ph == "b":
                async_stacks.setdefault(akey, []).append(ev["name"])
            elif ph == "e":
                stack = async_stacks.get(akey)
                if not stack:
                    raise ValueError(f"event {i}: 'e' without open 'b' "
                                     f"in lane {akey}")
                top = stack.pop()
                if top != ev["name"]:
                    raise ValueError(
                        f"event {i}: 'e' '{ev['name']}' closes '{top}'")
                n_async += 1
        else:
            raise ValueError(f"event {i}: unknown ph '{ph}'")
    dangling = sum(len(s) for s in stacks.values())
    if dangling:
        raise ValueError(f"{dangling} B events never closed")
    dangling = sum(len(s) for s in async_stacks.values())
    if dangling:
        raise ValueError(f"{dangling} async 'b' events never closed")
    return {"spans": n_spans, "instants": n_instants,
            "async_spans": n_async, "async_lanes": len(async_lanes),
            "counters": n_counters, "events": len(events)}
