"""Storage observability dashboard on the card: lifecycle audit + health
monitor (the counterpart of ``benchmarks/obs_dashboard.py``).

Drives a deliberately SATURATED hot-key stream (small rings, a small
spill pool / page slab, a long-held snapshot pin) through a
conflict-aware ``TxnService`` with the whole obs plane attached —
``LifecycleAuditor``, ``HealthMonitor``, ``FlightRecorder``,
``PhaseTracer`` — then renders:

  * the monitored gauge series with their EWMA baselines and alerts;
  * the lifecycle state-flow table + the telescoping conservation
    identity (every committed version has exactly one disposition);
  * the GC audit: death->reclamation delay distribution and the
    pin certification (zero reclaimed versions stabbable by a pin);
  * the found=False probes at the pin, each EXPLAINED by the concrete
    drop event the auditor captured;

and writes ``benchmarks_torch/results/obs_dashboard_trace.json`` (phase
spans + flight lanes + the monitor's counter tracks on one time origin),
``obs_dashboard.json`` (the summary twin) and ``obs_alerts.jsonl`` (the
monitor's event log), then prints the card's name and power limit.

``--validate`` re-reads the exported trace, checks the Chrome trace
invariants including counter tracks, and asserts that every found=False
probe was explained, the GC pin certification passed and the telescope
balances, in both configurations.

    python3 benchmarks_torch/obs_dashboard.py [--quick] [--validate]

Needs a GPU (exit 2 without one); ``run_config(..., device="cpu")`` is
the rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import (RESULTS_DIR, card_line,  # noqa: E402
                                     needs_cuda)
from benchmarks_torch.obs_report import inc_workload  # noqa: E402
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.txn import make_batch  # noqa: E402
from repro_torch.obs import (FlightRecorder, HealthMonitor,  # noqa: E402
                             LifecycleAuditor, PhaseTracer, run_metadata,
                             stitch_chrome_trace, validate_chrome_trace)
from repro_torch.obs.lifecycle import AUDIT_STATE_NAMES  # noqa: E402
from repro_torch.service import TxnService  # noqa: E402

R = 64          # few records...
HOT = 16        # ...hammered on a narrow hot set -> ring overflow
T, OPS = 32, 4
TOP_K = 8


def _hot_batch(rng, device):
    reads = rng.integers(0, HOT, (T, OPS))
    writes = np.where(rng.random((T, OPS)) < 0.7, reads, -1)
    return make_batch(reads, writes, np.zeros(T, np.int64),
                      rng.integers(1, 5, (T, 1)), device=device)


def _build(config: str, auditor, tracer, device):
    wl = inc_workload(read_only=False)
    if config == "spill":
        # 4-slot rings over a 2x4 spill pool: the pin keeps history live,
        # the pool saturates, drops follow
        return BohmEngine(R, wl, ring_slots=4, spill_buckets=2,
                          spill_slots=4, auditor=auditor, tracer=tracer,
                          device=device)
    # paged: barely more than one page per record — the hot set wants 2
    # pages each, so allocation fails under the pin
    return BohmEngine(R, wl, ring_slots=4, paged=True, page_slots=2,
                      pages_per_shard=R + 4, spill_slots=0,
                      auditor=auditor, tracer=tracer, device=device)


def run_config(config: str, n_batches: int, alerts_path,
               device="cuda") -> dict:
    tracer = PhaseTracer(enabled=True)
    recorder = FlightRecorder(enabled=True)
    auditor = LifecycleAuditor(capacity=65536, pending_cap=1024,
                               per_record_cap=8192)
    eng = _build(config, auditor, tracer, device)
    svc = TxnService(eng, max_inflight=2, admission_window=4,
                     flight=recorder)
    monitor = HealthMonitor(svc, cadence_s=0.0, alpha=0.3, threshold=2.0,
                            log_path=str(alerts_path))
    rng = np.random.default_rng(7)

    # two warmup batches, then pin a snapshot and HOLD it while the hot
    # stream overwrites the pinned history out of the primary tier
    for _ in range(2):
        svc.wait(svc.submit(_hot_batch(rng, device)))
    monitor.sample()
    pin = svc.begin_snapshot()
    pin_ts = pin.ts
    for i in range(n_batches):
        svc.wait(svc.submit(_hot_batch(rng, device)))
        monitor.tick()
        if i % 4 == 3:
            eng.gc_sweep()      # audited sweep + harvest boundary

    # the saturated store answers found=False (never stale) where the
    # pinned history was dropped: the auditor must explain each one
    _, found = eng.snapshot_read(np.arange(R), ts=pin_ts)
    found = found.cpu().numpy()
    probes = []
    unexplained = 0
    for r in np.nonzero(~found)[0]:
        exp = auditor.explain_read(int(r), pin_ts)
        concrete = exp["event"] is not None
        if not concrete:
            unexplained += 1
        probes.append({"record": int(r), "reason": exp["reason"],
                       "event": (dataclass_row(exp["event"])
                                 if concrete else None)})
    monitor.sample()

    svc.release_snapshot(pin)
    eng.gc_sweep()
    svc.drain()
    monitor.sample()
    return {
        "config": config, "auditor": auditor, "monitor": monitor,
        "tracer": tracer, "recorder": recorder, "pin_ts": pin_ts,
        "found_rate": round(float(found.mean()), 4),
        "probes": probes, "unexplained": unexplained,
        "telescope": auditor.telescope(), "gc": auditor.gc_report(),
        "states": auditor.state_counts(),
    }


def dataclass_row(ev) -> dict:
    return {"state": ev.state_name, "begin": ev.begin_ts,
            "end": ev.end_ts, "cause_ts": ev.cause_ts}


def _series_rows(monitor: HealthMonitor) -> list:
    rows = []
    baselines = monitor.baselines()
    for key in monitor.keys():
        vals = [v for _, v in monitor.series(key)]
        rows.append({
            "gauge": key, "samples": len(vals),
            "first": round(vals[0], 4), "last": round(vals[-1], 4),
            "max": round(max(vals), 4),
            "baseline": round(baselines.get(key) or 0.0, 4),
            "alerts": monitor.alerts.get(key, 0)})
    return rows


def report(out: dict) -> None:
    print(f"\n## Storage observability — {out['config']}\n")
    print("### Health series (monitored gauges)\n")
    print("| gauge | samples | first | last | max | baseline | alerts |")
    print("|---|---|---|---|---|---|---|")
    for row in _series_rows(out["monitor"]):
        print(f"| {row['gauge']} | {row['samples']} | {row['first']} | "
              f"{row['last']} | {row['max']} | {row['baseline']} | "
              f"{row['alerts']} |")

    print("\n### Version lifecycle state flow\n")
    print("| state | versions |")
    print("|---|---|")
    for key in ["initial"] + list(AUDIT_STATE_NAMES.values()) + [
            "gc_commit_reclaimed", "gc_spill_reclaimed",
            "gc_sweep_reclaimed"]:
        if key in out["states"]:
            print(f"| {key} | {out['states'][key]} |")
    t = out["telescope"]
    print(f"\ntelescope: committed_total={t['lhs_committed_total']} "
          f"disposed_total={t['rhs_disposed_total']} "
          f"balanced={t['balanced']} resident={t['resident']}")

    gc = out["gc"]
    print("\n### GC audit (death -> reclamation)\n")
    print(f"- sweeps: {gc['sweeps']}, reclaimed: {gc['reclaimed']}")
    print(f"- delay mean: {round(gc['delay_mean'], 2)} ts, "
          f"max: {gc['delay_max']} ts")
    print(f"- delay histogram (log2 buckets): {gc['delay_hist_log2']}")
    print(f"- pin-stabbable reclamations: {gc['pin_stabbed_reclaims']} "
          f"(must be 0)")

    print(f"\n### found=False probes at pinned ts {out['pin_ts']} "
          f"(found_rate {out['found_rate']})\n")
    print("| record | reason | drop event |")
    print("|---|---|---|")
    for p in out["probes"][:TOP_K]:
        ev = p["event"]
        desc = (f"[{ev['begin']}, {ev['end']}) {ev['state']} "
                f"@ts {ev['cause_ts']}" if ev else "-")
        print(f"| {p['record']} | {p['reason']} | {desc} |")
    print(f"\nunexplained probes: {out['unexplained']} (must be 0)")


def validate(trace_path: Path, outs: list) -> dict:
    """The stitched trace's invariants (spans, counters, lanes) and, per
    configuration, the auditor's gates; raises on the first failure."""
    counts = validate_chrome_trace(json.loads(trace_path.read_text()))
    assert counts["spans"] > 0, "no phase spans in trace"
    assert counts["counters"] > 0, "no health counter tracks"
    assert counts["async_lanes"] > 0, "no flight lanes"
    for out in outs:
        cfg = out["config"]
        assert out["probes"], \
            f"{cfg}: stream never saturated (no found=False probes)"
        assert out["unexplained"] == 0, \
            f"{cfg}: {out['unexplained']} probes unexplained"
        assert out["gc"]["pin_stabbed_reclaims"] == 0, \
            f"{cfg}: GC reclaimed pin-stabbable versions"
        assert out["telescope"]["balanced"], \
            f"{cfg}: lifecycle telescope unbalanced"
    return counts


def run(n_batches: int, device="cuda") -> tuple:
    """Both configurations; writes the artifacts. Returns (outs, trace
    path)."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    alerts_path = RESULTS_DIR / "obs_alerts.jsonl"
    alerts_path.write_text("")      # fresh log per run
    outs = [run_config(cfg, n_batches, alerts_path, device)
            for cfg in ("spill", "paged")]
    out0 = outs[0]
    trace = stitch_chrome_trace(out0["tracer"], out0["recorder"],
                                monitor=out0["monitor"])
    trace_path = RESULTS_DIR / "obs_dashboard_trace.json"
    with open(trace_path, "w") as f:
        json.dump(trace, f, indent=1)
    summary_path = RESULTS_DIR / "obs_dashboard.json"
    with open(summary_path, "w") as f:
        json.dump({"meta": run_metadata(), "rows": [
            {k: v for k, v in out.items()
             if k not in ("auditor", "monitor", "tracer", "recorder")}
            for out in outs]}, f, indent=2, default=str)
    n_alerts = sum(1 for _ in open(alerts_path))
    print(f"\ntrace: {trace_path}\nsummary: {summary_path}\n"
          f"alerts: {alerts_path} ({n_alerts} events)")
    return outs, trace_path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="short stream")
    ap.add_argument("--validate", action="store_true",
                    help="re-read the exported trace, check its "
                         "invariants incl. counter tracks, and assert "
                         "every probe explained")
    ap.add_argument("--batches", type=int, default=None)
    args = ap.parse_args()
    if not needs_cuda("obs_dashboard"):
        return 2
    outs, trace_path = run(args.batches or (6 if args.quick else 24))
    for out in outs:
        report(out)
    if args.validate:
        print(f"dashboard valid: {validate(trace_path, outs)}")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
