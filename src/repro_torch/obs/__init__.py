"""repro_torch.obs — the telemetry plane (port, first slice).

``MetricsRegistry`` is ported in full. ``PhaseTracer`` keeps the
reference's span and instant interface: disabled (the default) its spans
and instants are no-ops with zero host syncs; enabled it records each
span's synchronised wall time (``span_durations``), each instant's name,
host time and fields (``instants``) and, with ``annotate=True``, opens a
``torch.profiler.record_function`` range per span. ``NULL_AUDIT`` is the
inert lifecycle auditor.

``flight``     ``FlightRecorder``: per-ticket lifecycle records through
               the out-of-order scheduler, telescoping latency
               breakdowns, conflict attribution with footprint
               witnesses and per-class quantile digests (OFF = one
               attribute test per hook, zero fences on or off).
``quantiles``  ``LogHistogram``: streaming p50/p99 with bounded relative
               error.
``health``     MVCC gauges computed from store state on demand
               (``engine_health``, ``service_health``) and the serving
               plane's host-only ``scheduler_health``.

The tracer's event ring, anomaly detector and Chrome-trace export (and
with it ``stitch_chrome_trace``), the lifecycle auditor and the health
monitor are later slices (ROADMAP.md, queue 1 slice E).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from repro_torch.obs.flight import NULL_FLIGHT, FlightRecorder, TicketFlight
from repro_torch.obs.health import (engine_health, scheduler_health,
                                    service_health)
from repro_torch.obs.quantiles import LogHistogram
from repro_torch.obs.registry import MetricsRegistry, MetricsView


class _NullSpan:
    """A disabled span: ``fence`` returns its argument without waiting."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, x):
        return x

    def note(self, **fields) -> None:
        pass


NULL_SPAN = _NullSpan()


def _sync() -> None:
    # CPU tensor work is synchronous; CUDA work waits for the device
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Span:
    """An enabled span: the device is synchronised when it opens and, if
    a value was fenced, when it closes, so its wall time is the phase's."""

    def __init__(self, tracer: "PhaseTracer", name: str):
        self._tracer = tracer
        self.name = name
        self._fenced = False
        self._range = None

    def fence(self, x):
        """Mark the value whose realisation ends this span (returned
        unchanged). CUDA work is waited for stream-wide at exit."""
        self._fenced = True
        return x

    def note(self, **fields) -> None:
        pass

    def __enter__(self):
        if self._tracer.annotate:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._fenced:
            _sync()
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tracer._durations.setdefault(self.name, []).append(dt)
        return False


class PhaseTracer:
    """Phase spans around the engine's phases (see the module doc)."""

    def __init__(self, enabled: bool = False, annotate: bool = False):
        self.enabled = enabled
        self.annotate = annotate
        self._durations: Dict[str, List[float]] = {}
        self._instants: List[Tuple[str, float, Dict]] = []

    def span(self, name: str, **fields):
        """Context manager for one phase span; the disabled tracer returns
        the shared no-op span."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name)

    def instant(self, name: str, **fields) -> None:
        """A point event (admission, GC and planning decisions): recorded
        with its host time and fields when enabled, nothing otherwise."""
        if self.enabled:
            self._instants.append((name, time.perf_counter(), fields))

    def span_durations(self) -> Dict[str, List[float]]:
        """Per-name wall durations (seconds) of the closed spans."""
        return {k: list(v) for k, v in self._durations.items()}

    def instants(self) -> List[Tuple[str, float, Dict]]:
        """The recorded instants as (name, host seconds, fields)."""
        return list(self._instants)

    def clear(self) -> None:
        self._durations.clear()
        self._instants.clear()


class _NullAudit:
    """The inert lifecycle auditor the engine calls when auditing is off."""
    enabled = False
    gc_event_cap = 0

    def on_commit(self, metrics) -> None:
        pass

    def harvest(self) -> None:
        pass


NULL_AUDIT = _NullAudit()

__all__ = ["FlightRecorder", "LogHistogram", "MetricsRegistry",
           "MetricsView", "NULL_AUDIT", "NULL_FLIGHT", "NULL_SPAN",
           "PhaseTracer", "TicketFlight", "engine_health",
           "scheduler_health", "service_health"]
