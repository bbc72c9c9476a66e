"""Benchmark trajectory writer + regression gate over
``repro_torch.obs.regress`` (the counterpart of
``benchmarks/bench_history.py``).

Appends each suite's HEADLINE metrics (a handful of numbers per suite,
extracted from its JSON twin under ``benchmarks_torch/results/``) to a
provenance-stamped history of the port's own,

    benchmarks_torch/history/BENCH_<suite>.json
        {"suite": ..., "entries": [{"meta": run_metadata(),
                                    "metrics": {...}}, ...]}

and gates the newest entry against the EWMA baseline of the prior ones
(``EwmaAnomaly``), with metric direction inferred from the name
(``regress.direction_for``). The repo root's ``BENCH_*.json`` are the
JAX reference's histories: nothing here writes them.

    # after a benchmark run, record its headline metrics:
    python3 benchmarks_torch/bench_history.py --append
    # gate the newest entries (report-only; --strict exits nonzero):
    python3 benchmarks_torch/bench_history.py --check

Wall-clock metrics move between chip calls (other hosts, other power
limits), so ``--strict`` is for one machine's trend only. Reads and
writes files only, so it runs anywhere.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.summarize import bench_meta, bench_rows  # noqa: E402
from repro_torch.obs import (append_entry, check_history,  # noqa: E402
                             history_path, load_history)

HISTORY_DIR = Path(__file__).resolve().parent / "history"


def _sel(rows: List[Dict], **match) -> Optional[Dict]:
    for r in rows:
        if all(r.get(k) == v for k, v in match.items()):
            return r
    return None


def _num(row: Optional[Dict], key: str) -> Optional[float]:
    v = row.get(key) if row else None
    return float(v) if isinstance(v, (int, float)) else None


# -- per-suite headline extractors (twin rows -> flat metrics dict) -------
def _extract_admission(rows: List[Dict]) -> Dict[str, float]:
    out = {}
    for stream in ("disjoint_cold", "mixed"):
        r = _sel(rows, stream=stream, mode="ooo")
        for key in ("txn_s", "vs_barriered", "vs_fifo4"):
            v = _num(r, key)
            if v is not None:
                out[f"{stream}_ooo_{key}"] = v
    return out


def _extract_admission_latency(rows: List[Dict]) -> Dict[str, float]:
    out = {}
    for mode in ("ooo", "barriered"):
        for cls in ("interactive", "bulk"):
            r = _sel(rows, mode=mode, **{"class": cls})
            for key in ("p50_ms", "p99_ms"):
                v = _num(r, key)
                if v is not None:
                    out[f"{mode}_{cls}_{key}"] = v
    return out


def _extract_pipeline(rows: List[Dict]) -> Dict[str, float]:
    out = {}
    for r in rows:
        shards, mode = r.get("n_shards"), r.get("mode")
        if mode == "pipelined":
            v = _num(r, "txn_s")
            if v is not None:
                out[f"shards{shards}_txn_s"] = v
        elif mode == "speedup":
            v = _num(r, "pipelined_over_barriered")
            if v is not None:
                out[f"shards{shards}_speedup"] = v
    return out


def _extract_storage(rows: List[Dict]) -> Dict[str, float]:
    out = {}
    for r in rows:
        cfg = r.get("config")
        if not cfg:
            continue
        # phys_kwords only exists in the paged twin
        for key in ("found_rate", "txn_s", "phys_kwords"):
            v = _num(r, key)
            if v is not None:
                out[f"{cfg}_{key}"] = v
    return out


def _extract_arena(rows: List[Dict]) -> Dict[str, float]:
    """Committed throughput per protocol on the most contended zipfian
    cell (the headline claim's cell) + SmallBank high-contention Bohm."""
    out = {}
    zipf = [r for r in rows if r.get("kind") == "ycsb"
            and r.get("mix") == "10rmw" and (r.get("theta") or 0) > 0]
    if zipf:
        top = max(r["theta"] for r in zipf)
        for r in zipf:
            if r["theta"] == top:
                v = _num(r, "txn_s")
                if v is not None:
                    out[f"zipf_{r['protocol']}_txn_s"] = v
    r = _sel(rows, cell="smallbank-high", protocol="bohm-ca")
    v = _num(r, "txn_s")
    if v is not None:
        out["smallbank_high_bohm_ca_txn_s"] = v
    return out


SUITES = {
    "admission": _extract_admission,
    "admission_latency": _extract_admission_latency,
    "pipeline": _extract_pipeline,
    "spill": _extract_storage,
    "paged": _extract_storage,
    "arena": _extract_arena,
}


def append_suites(suites=None, root: Path = HISTORY_DIR) -> List[str]:
    """Extract + append headline metrics for every suite whose twin
    exists under ``benchmarks_torch/results/``; returns the suites
    recorded."""
    recorded = []
    for suite in (suites or SUITES):
        rows = bench_rows(suite)
        if rows is None:
            continue
        metrics = SUITES[suite](rows)
        if not metrics:
            print(f"{suite}: twin has no headline metrics, skipped")
            continue
        Path(root).mkdir(parents=True, exist_ok=True)
        path = history_path(suite, str(root))
        append_entry(path, suite, metrics, meta=bench_meta(suite))
        n = len(load_history(path)["entries"])
        print(f"{suite}: appended {len(metrics)} metrics -> {path} "
              f"({n} entries)")
        recorded.append(suite)
    return recorded


def check_suites(suites=None, root: Path = HISTORY_DIR,
                 threshold: float = 1.5) -> List:
    """Run the regression gate over every existing history file;
    returns the flagged regressions (report-only — caller decides)."""
    flagged = []
    for suite in (suites or SUITES):
        path = history_path(suite, str(root))
        if not Path(path).exists():
            continue
        hist = load_history(path)
        regs = check_history(hist, threshold=threshold)
        n = len(hist["entries"])
        if regs:
            for r in regs:
                print(f"REGRESSION {r.describe()}")
            flagged.extend(regs)
        else:
            print(f"{suite}: OK ({n} entries, no regressions)")
    return flagged


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--append", action="store_true",
                    help="append headline metrics from results/ twins")
    ap.add_argument("--check", action="store_true",
                    help="gate newest entries against EWMA baselines")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero when --check flags a regression")
    ap.add_argument("--suites", default=None,
                    help=f"comma subset of {','.join(SUITES)}")
    ap.add_argument("--threshold", type=float, default=1.5,
                    help="EWMA anomaly threshold (default 1.5x)")
    args = ap.parse_args()
    suites = args.suites.split(",") if args.suites else None
    if suites:
        unknown = set(suites) - set(SUITES)
        if unknown:
            ap.error(f"unknown suites: {sorted(unknown)}")
    if not (args.append or args.check):
        ap.error("nothing to do: pass --append and/or --check")
    if args.append:
        append_suites(suites)
    if args.check:
        flagged = check_suites(suites, threshold=args.threshold)
        if flagged and args.strict:
            sys.exit(f"{len(flagged)} regression(s) flagged")


if __name__ == "__main__":
    main()
