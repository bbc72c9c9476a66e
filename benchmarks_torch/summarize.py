"""Summarise the port's benchmark artifacts into one markdown report (the
counterpart of ``benchmarks/summarize.py``).

    python3 benchmarks_torch/summarize.py

Three sections, each emitted only when its artifacts exist under
``benchmarks_torch/results/``:

  * the MVCC benchmark tables: the JSON twins written by
    ``benchmarks_torch/run.py``, selected columns per benchmark;
  * the observability section: phase span stats, health gauges and the
    provenance stamp from ``benchmarks_torch/obs_report.py``'s artifacts;
  * the optimized-vs-baseline roofline summary of two dry-run artifacts,
    ``dryrun_baseline.json`` and ``dryrun_opt.json`` (written by
    ``python -m repro_torch.launch.dryrun --out ...``), through
    ``repro_torch.launch.roofline.analyze_cell`` over the H100 model.

Reads files only, so it runs anywhere.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.roofline import analyze_cell  # noqa: E402

RESULTS = Path(__file__).resolve().parent / "results"

# benchmark name -> (title, ordered columns to surface; None = all)
BENCH_TABLES = {
    "pipeline": ("pipeline — pipelined vs barriered (Fig 3 overlap)",
                 ["n_shards", "mode", "substrate", "txn_s",
                  "pipelined_over_barriered"]),
    "admission": ("admission — out-of-order scheduler vs FIFO-prefix "
                  "vs barriered",
                  ["stream", "mode", "admission_window", "txn_s",
                   "vs_barriered", "vs_fifo4", "merged_batches",
                   "hopped_batches", "overlapped_execs",
                   "chain_depth_max"]),
    "admission_latency": ("admission latency classes — per-class ticket "
                          "latency (interactive jumps bulk)",
                          ["mode", "class", "n_tickets", "p50_ms",
                           "p99_ms", "max_ms", "txn_s",
                           "class_promotions"]),
    "spill": ("spill — hierarchical storage found-rate at equal budget",
              ["config", "found_rate", "found_vs_drop", "txn_s",
               "txn_s_vs_drop", "spill_admitted", "spill_dropped",
               "k_min_eff", "k_max_eff"]),
    "paged": ("paged — page slab vs dense rings, found-rate per word",
              ["config", "phys_slots", "phys_kwords", "found_rate",
               "found_vs_budget", "txn_s", "txn_s_vs_budget",
               "pages_mapped", "pages_free", "alloc_failed"]),
    "admission_flight": ("admission flight — per-ticket latency "
                         "breakdown (queue/formation/exec/commit_defer "
                         "sum to end-to-end)",
                         ["ticket", "class", "epoch", "epoch_batches",
                          "chain_depth", "hops", "blocked_events",
                          "queue_ms", "formation_ms", "exec_ms",
                          "commit_defer_ms", "total_ms"]),
    "admission_flight_blocking": ("admission flight — blocking-records "
                                  "heatmap (conflict attribution, "
                                  "top-K witnesses + per-kind counts)",
                                  ["record", "blocks"]),
    "arena": ("arena — cross-protocol matrix + anomaly gauntlet "
              "(committed txn/s, MVSG verdicts)",
              ["cell", "protocol", "txn_s", "abort_rate", "verdict",
               "as_expected", "proxy"]),
    "ycsb": ("ycsb — Figs 5-7 via arena adapters (committed txn/s)",
             ["cell", "protocol", "theta", "mix", "txn_s", "abort_rate",
              "verdict", "proxy"]),
    "smallbank": ("smallbank — Figs 8-10 via arena adapters",
                  ["cell", "protocol", "customers", "mix", "txn_s",
                   "abort_rate", "verdict", "proxy"]),
}


def _twin(name: str):
    path = RESULTS / f"{name}.json"
    return json.loads(path.read_text()) if path.exists() else None


def bench_rows(name: str):
    data = _twin(name)
    rows = data.get("rows") if isinstance(data, dict) else data
    return rows if isinstance(rows, list) and rows else None


def bench_meta(name: str):
    data = _twin(name)
    return data.get("meta") if isinstance(data, dict) else None


def _latency_rows_from_flight():
    """Fallback for the ``admission_latency`` table: per-class quantiles
    computed from the flight twin's per-ticket end-to-end breakdowns."""
    flight = bench_rows("admission_flight")
    if flight is None:
        return None
    by_class = {}
    for r in flight:
        if "total_ms" in r:
            by_class.setdefault(r.get("class", "?"), []).append(
                float(r["total_ms"]))
    rows = []
    for cls, ms in sorted(by_class.items()):
        arr = np.asarray(ms)
        rows.append({
            "mode": "flight", "class": cls, "n_tickets": len(ms),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3),
            "max_ms": round(float(arr.max()), 3),
        })
    return rows or None


def print_bench_tables() -> bool:
    """The MVCC benchmark section; returns True when anything printed."""
    printed = False
    for name, (title, columns) in BENCH_TABLES.items():
        rows = bench_rows(name)
        if rows is None and name == "admission_latency":
            rows = _latency_rows_from_flight()
        if rows is None:
            continue
        cols = [c for c in (columns or list(rows[0].keys()))
                if any(c in r for r in rows)]
        if not cols:
            continue
        print(f"\n### {title}\n")
        print("| " + " | ".join(cols) + " |")
        print("|" + "---|" * len(cols))
        for r in rows:
            print("| " + " | ".join(str(r.get(c, "")) for c in cols)
                  + " |")
        printed = True
    if not printed:
        print("(no benchmark JSON twins under benchmarks_torch/results/ — "
              "run `python3 benchmarks_torch/run.py` first)")
    return printed


def print_obs_section() -> bool:
    """Observability artifacts (``benchmarks_torch/obs_report.py``):
    phase span stats, selected health gauges, and the provenance
    stamp."""
    data = _twin("obs_health")
    if data is None:
        return False
    print("\n## Observability (obs_report artifacts)\n")
    meta = data.get("meta") or {}
    if meta:
        print(f"run: torch {meta.get('torch_version')} / CUDA "
              f"{meta.get('cuda_version')} / {meta.get('device_name')} "
              f"x{meta.get('device_count')} / git {meta.get('git_sha')} / "
              f"{meta.get('timestamp')}\n")
    phases = data.get("phases") or []
    if phases:
        print("| phase | count | mean ms | p50 ms | max ms | anomalies |")
        print("|---|---|---|---|---|---|")
        for p in phases:
            print(f"| {p['phase']} | {p['count']} | {p['mean_ms']} | "
                  f"{p['p50_ms']} | {p['max_ms']} | {p['anomalies']} |")
    health = data.get("health") or {}
    gauges = [k for k in ("watermark_lag", "active_pins", "live_versions",
                          "ring_fill_p50", "ring_fill_max",
                          "pressure_max", "admission_queue_depth")
              if k in health]
    if gauges:
        print("\n| gauge | value |")
        print("|---|---|")
        for k in gauges:
            print(f"| {k} | {health[k]} |")
    trace = RESULTS / "obs_trace.json"
    if trace.exists():
        print(f"\ntrace: {trace} (load in Perfetto / chrome://tracing)")
    return True


def rows_from(path: Path, mesh: str):
    data = json.loads(path.read_text())
    out = {}
    for key, rec in sorted(data.items()):
        if not key.endswith(f"|{mesh}"):
            continue
        r = analyze_cell(key, rec)
        if r:
            out[(r["arch"], r["shape"])] = r
    return out


def gmean(xs):
    xs = [x for x in xs if x > 0]
    return float(np.exp(np.mean(np.log(xs)))) if xs else 0.0


def print_roofline_section() -> bool:
    """The reference's roofline summary over ``dryrun_baseline.json`` and
    ``dryrun_opt.json``: gmean terms per cell group, baseline vs
    optimized, then the optimized single-mesh cells."""
    base_path = RESULTS / "dryrun_baseline.json"
    opt_path = RESULTS / "dryrun_opt.json"
    if not (base_path.exists() and opt_path.exists()):
        return False
    print("\n## Roofline (dry-run artifacts)\n")
    base = rows_from(base_path, "single")
    opt = rows_from(opt_path, "single")
    keys = sorted(set(base) & set(opt))

    def agg(rows, field, keys_):
        return gmean([rows[k][field] for k in keys_])

    train = [k for k in keys if k[1] == "train_4k"]
    serve = [k for k in keys if k[1] in ("decode_32k", "long_500k")]
    pre = [k for k in keys if k[1] == "prefill_32k"]

    lines = []
    lines.append("| cell group | metric | baseline | optimized | ratio |")
    lines.append("|---|---|---|---|---|")
    for name, ks in [("train_4k (10)", train), ("prefill_32k (10)", pre),
                     ("decode (12)", serve)]:
        for metric, label, fmt in [
                ("t_memory_s", "memory term", 1e3),
                ("t_collective_s", "collective term", 1e3),
                ("t_compute_s", "compute term", 1e3)]:
            b = agg(base, metric, ks)
            o = agg(opt, metric, ks)
            lines.append(f"| {name} | {label} (gmean ms) | {b*fmt:.2f} | "
                         f"{o*fmt:.2f} | {o/b:.2f}x |")
        if name.startswith("train"):
            b = agg(base, "roofline_fraction", ks)
            o = agg(opt, "roofline_fraction", ks)
            of = agg(opt, "roofline_fraction_fused", ks)
            lines.append(f"| {name} | roofline fraction (gmean) | "
                         f"{b:.1%} | {o:.1%} ({of:.1%} fused) | {o/b:.2f}x |")
    print("\n".join(lines))

    # per-cell optimized table (markdown) for the appendix
    print("\nPer-cell optimized (single-pod):\n")
    print("| arch | shape | comp ms | mem ms | memF ms | coll ms | "
          "dominant | useful | roofl | roofF |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for k in keys:
        r = opt[k]
        print(f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.2f} | "
              f"{r['t_memory_s']*1e3:.2f} | {r['t_memory_fused_s']*1e3:.2f} |"
              f" {r['t_collective_s']*1e3:.3f} | {r['dominant']} | "
              f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.1%} | "
              f"{r['roofline_fraction_fused']:.1%} |")
    return True


def main() -> None:
    print("## MVCC benchmarks (JSON twins)")
    print_bench_tables()
    print_obs_section()
    print_roofline_section()


if __name__ == "__main__":
    main()
