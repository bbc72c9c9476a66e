"""Observability report on the card: run a traced workload, export the
artifacts (the counterpart of ``benchmarks/obs_report.py``).

Drives a conflict-aware ``TxnService`` stream with tracing enabled and a
shared ``MetricsRegistry``, then writes

  benchmarks_torch/results/obs_trace.json   Chrome ``trace_event`` JSON of
                             the run's plan/exec/commit spans,
                             admission-decision instants, gc spans AND
                             the flight recorder's per-ticket async
                             lanes (Perfetto / chrome://tracing);
  benchmarks_torch/results/obs_health.json  {"meta", "health",
                             "counters", "phases"}: the post-run MVCC
                             health gauges, the registry snapshot and
                             per-phase wall-time stats from the span
                             ring;

and prints a markdown health report and the card's name and power
limit. ``--validate`` re-reads the exported trace and checks the Chrome
trace invariants and the scheduler's decision instants.

    python3 benchmarks_torch/obs_report.py [--quick] [--validate] [--spill]

Needs a GPU (exit 2 without one); ``run(..., device="cpu")`` is the
rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import (RESULTS_DIR, card_line,  # noqa: E402
                                     needs_cuda)
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.txn import Workload, make_batch  # noqa: E402
from repro_torch.obs import (FlightRecorder, PhaseTracer,  # noqa: E402
                             run_metadata, stitch_chrome_trace,
                             validate_chrome_trace)
from repro_torch.service import TxnService  # noqa: E402

T, OPS, R = 64, 4, 256
N_PARTS = 8


def inc_workload(ops: int = OPS, read_only: bool = True) -> Workload:
    """Type 0 adds ``args[0]`` to word 0 of every read record; type 1
    (with ``read_only``) only reads."""
    def rmw(vals, args):
        out = vals.clone()
        out[..., 0] += args[:, :1]
        return out, torch.zeros(vals.shape[0], dtype=torch.bool,
                                device=vals.device)

    def read(vals, args):
        return vals, torch.zeros(vals.shape[0], dtype=torch.bool,
                                 device=vals.device)

    return Workload(name="inc", n_read=ops, n_write=ops, payload_words=2,
                    branches=(rmw, read) if read_only else (rmw,))


def _batch(rng, device, part=None, ops=OPS, t=T):
    """Partition-local batches: each batch's keys stay inside one of
    ``N_PARTS`` record ranges, so the admission window sees disjoint
    batches (merge / overlap / hop) AND same-partition collisions.
    Partition 0 is reserved for the interactive point batch, so its
    queue jump is always hop-legal."""
    if part is None:
        part = int(rng.integers(1, N_PARTS))
    lo, hi = part * R // N_PARTS, (part + 1) * R // N_PARTS
    reads = rng.integers(lo, hi, (t, ops))
    writes = np.where(rng.random((t, ops)) < 0.5, reads, -1)
    return make_batch(reads, writes, rng.integers(0, 2, t),
                      rng.integers(1, 5, (t, 1)), device=device)


def run(n_batches: int, spill: bool, device="cuda") -> dict:
    tracer = PhaseTracer(enabled=True, anomaly_threshold=3.0)
    recorder = FlightRecorder(enabled=True)
    eng = BohmEngine(R, inc_workload(), ring_slots=8,
                     spill_slots=64 if spill else 0, tracer=tracer,
                     device=device)
    svc = TxnService(eng, max_inflight=2, admission_window=4,
                     flight=recorder)
    rng = np.random.default_rng(0)
    tickets = svc.submit_many([_batch(rng, device)
                               for _ in range(n_batches)])
    # deterministic decision tail: two same-partition bulk batches are
    # held, an interactive point batch jumps them (admission/hop +
    # admission/class_promote), and two commuting width-mismatched
    # batches dispatch as one exec chain (admission/chain_depth)
    tickets += svc.submit_many([_batch(rng, device, part=3),
                                _batch(rng, device, part=3)])
    tickets.append(svc.submit(_batch(rng, device, part=0, ops=2, t=16),
                              latency_class="interactive"))
    tickets += svc.submit_many([_batch(rng, device, part=1, ops=3),
                                _batch(rng, device, part=2, ops=5)])
    snap = svc.begin_snapshot()
    for t in tickets:
        svc.wait(t)
    svc.release_snapshot(snap)
    eng.gc_sweep()
    svc.drain()

    health = svc.health()
    counters = eng.metrics.snapshot(include_gauges=False)
    phases = []
    for name, durs in sorted(tracer.span_durations().items()):
        d = np.asarray(durs) * 1e3
        phases.append({"phase": name, "count": len(durs),
                       "mean_ms": round(float(d.mean()), 4),
                       "p50_ms": round(float(np.percentile(d, 50)), 4),
                       "max_ms": round(float(d.max()), 4),
                       "anomalies": tracer.anomalies.get(name, 0)})

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = RESULTS_DIR / "obs_trace.json"
    with open(trace_path, "w") as f:
        json.dump(stitch_chrome_trace(tracer, recorder), f, indent=1)
    health_path = RESULTS_DIR / "obs_health.json"
    with open(health_path, "w") as f:
        json.dump({"meta": run_metadata(), "health": health,
                   "counters": counters, "phases": phases}, f, indent=2,
                  default=str)
    return {"trace_path": trace_path, "health_path": health_path,
            "health": health, "counters": counters, "phases": phases}


def report(out: dict) -> None:
    print("## Observability report\n")
    print("### Phase spans\n")
    print("| phase | count | mean ms | p50 ms | max ms | anomalies |")
    print("|---|---|---|---|---|---|")
    for p in out["phases"]:
        print(f"| {p['phase']} | {p['count']} | {p['mean_ms']} | "
              f"{p['p50_ms']} | {p['max_ms']} | {p['anomalies']} |")
    print("\n### Health gauges\n")
    print("| gauge | value |")
    print("|---|---|")
    for k, v in out["health"].items():
        if not isinstance(v, (list, dict)):
            print(f"| {k} | {v} |")
    slo = out["health"].get("flight_slo") or {}
    if slo:
        print("\n### Flight SLO (per latency class)\n")
        print("| class | count | p50 ms | p99 ms | mean ms |")
        print("|---|---|---|---|---|")
        for cls, g in sorted(slo.items()):
            print(f"| {cls} | {g['count']} | {g['p50_ms']} | "
                  f"{g['p99_ms']} | {g['mean_ms']} |")
    blocking = out["health"].get("flight_blocking_records") or []
    if blocking:
        print("\n### Blocking records (conflict attribution top-K)\n")
        print("| record | blocks |")
        print("|---|---|")
        for rec, n_ in blocking:
            print(f"| {rec} | {n_} |")
    print("\n### Counters\n")
    print("| counter | value |")
    print("|---|---|")
    for k, v in sorted(out["counters"].items()):
        if isinstance(v, (int, float)):
            print(f"| {k} | {v} |")
    print(f"\ntrace: {out['trace_path']}")
    print(f"health: {out['health_path']}")


def validate(trace_path: Path) -> dict:
    """The Chrome trace invariants, the scheduler's decision instants and
    the flight lanes; raises ``AssertionError``/``ValueError``."""
    trace = json.loads(trace_path.read_text())
    counts = validate_chrome_trace(trace)
    assert counts["spans"] > 0, "trace exported no spans"
    assert any(e["ph"] == "i" for e in trace["traceEvents"]), \
        "trace exported no admission-decision instants"
    names = {e.get("name") for e in trace["traceEvents"]}
    missing = {"admission/hop", "admission/chain_depth",
               "admission/class_promote"} - names
    assert not missing, f"scheduler instants missing: {missing}"
    assert counts["async_lanes"] > 0, "no flight-recorder async lanes"
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="short stream")
    ap.add_argument("--validate", action="store_true",
                    help="re-read the exported trace and check its "
                         "invariants")
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("--spill", action="store_true",
                    help="attach a spill tier so spill gauges are live")
    args = ap.parse_args()
    if not needs_cuda("obs_report"):
        return 2
    out = run(args.batches or (8 if args.quick else 32), spill=args.spill)
    report(out)
    if args.validate:
        print(f"trace valid: {validate(out['trace_path'])}")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
