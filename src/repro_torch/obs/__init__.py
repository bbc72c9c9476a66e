"""repro_torch.obs — the zero-sync telemetry plane (port of ``repro.obs``).

Instrumentation keeps the engine's contract: nothing on the hot path
joins the host, on or off. The layers:

``registry``   ``MetricsRegistry``: typed counters / gauges with on-device
               tensor accumulation on the hot path and ONE host transfer
               at ``snapshot()``.
``trace``      ``PhaseTracer``: bounded-ring span instrumentation around
               plan/exec/commit, gc_sweep, reassign_k and admission
               decisions, waited on through ``repro_torch.device.fence``
               only at a fenced span's close when tracing is ON (OFF =
               zero fences, tested). Exports Chrome ``trace_event`` JSON
               (Perfetto-loadable); optional ``torch.profiler``
               ``record_function`` ranges (``annotate=True``).
``flight``     ``FlightRecorder``: per-ticket lifecycle records through
               the out-of-order scheduler, telescoping latency
               breakdowns, conflict attribution with footprint
               witnesses, per-class quantile digests, Chrome async lanes
               stitched into the tracer's export
               (``stitch_chrome_trace``).
``quantiles``  ``LogHistogram``: streaming p50/p99 with bounded relative
               error.
``health``     MVCC gauges computed from store state on demand
               (``engine_health``, ``service_health``) and the serving
               plane's host-only ``scheduler_health``.
``lifecycle``  ``LifecycleAuditor``: every version transition (committed,
               overwritten, spilled, page-dropped, gc-reclaimed) into
               per-state device counters + a bounded host audit ring,
               harvested in one transfer at sweep/snapshot/drain
               boundaries (zero fences on or off); the
               ``inspect_record`` time-travel inspector and the GC
               delay/pin-certification audit.
``monitor``    ``HealthMonitor``: fixed-cadence ``health()`` sampling into
               bounded series, EWMA warn/crit alerts with a JSONL log,
               Chrome counter tracks.
``regress``    benchmark trajectory: append-only ``BENCH_<suite>.json``
               histories under a caller-named root, stamped with
               ``run_metadata()`` and gated by ``EwmaAnomaly`` baselines.

``ewma`` (shared anomaly baselines) and ``meta`` (``run_metadata()``,
the provenance block of every benchmark and arena artifact: torch and
CUDA versions, device, git SHA, timestamp) ride along.
"""
from repro_torch.obs.ewma import Ewma, EwmaAnomaly
from repro_torch.obs.flight import (NULL_FLIGHT, FlightRecorder,
                                    TicketFlight, stitch_chrome_trace)
from repro_torch.obs.health import (engine_health, scheduler_health,
                                    service_health)
from repro_torch.obs.lifecycle import (NULL_AUDIT, AuditEvent,
                                       LifecycleAuditor, RecordTimeline)
from repro_torch.obs.meta import git_sha, run_metadata
from repro_torch.obs.monitor import NULL_MONITOR, HealthMonitor
from repro_torch.obs.quantiles import LogHistogram
from repro_torch.obs.regress import (Regression, append_entry,
                                     check_history, direction_for,
                                     history_path, load_history)
from repro_torch.obs.registry import MetricsRegistry, MetricsView
from repro_torch.obs.trace import (NULL_SPAN, PhaseTracer,
                                   validate_chrome_trace)

__all__ = [
    "AuditEvent", "Ewma", "EwmaAnomaly", "FlightRecorder",
    "HealthMonitor", "LifecycleAuditor", "LogHistogram",
    "MetricsRegistry", "MetricsView", "NULL_AUDIT", "NULL_FLIGHT",
    "NULL_MONITOR", "NULL_SPAN", "PhaseTracer", "RecordTimeline",
    "Regression", "TicketFlight", "append_entry", "check_history",
    "direction_for", "engine_health", "git_sha", "history_path",
    "load_history", "run_metadata", "scheduler_health", "service_health",
    "stitch_chrome_trace", "validate_chrome_trace",
]
