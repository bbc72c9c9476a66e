"""Shared benchmark harness utilities of the port (the counterpart of
``benchmarks/common.py``): CSV and JSON twins under
``benchmarks_torch/results/`` in the reference's shape, ``{"meta":
run_metadata(), "rows": [...]}``, a median timer that joins through
``repro_torch.device.fence``, and the card's name and power limit.
"""
from __future__ import annotations

import csv
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.obs import run_metadata

RESULTS_DIR = Path(__file__).resolve().parent / "results"


def _join(out) -> None:
    """``device.fence`` every tensor of a (nested) result."""
    if isinstance(out, torch.Tensor):
        device_mod.fence(out)
    elif isinstance(out, dict):
        for v in out.values():
            _join(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _join(v)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            **kw) -> float:
    """Median wall seconds per call, each joined through
    ``device.fence``."""
    for _ in range(warmup):
        _join(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _join(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def write_csv(name: str, rows: List[Dict], print_rows: bool = True) -> Path:
    """Write rows as CSV and the JSON twin."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.csv"
    if rows:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    write_json(name, rows)
    if print_rows:
        for r in rows:
            print(",".join(f"{k}={v}" for k, v in r.items()), flush=True)
    return path


def write_json(name: str, rows: List[Dict]) -> Path:
    """JSON twin format: ``{"meta": run_metadata(), "rows": [...]}`` —
    every artifact is stamped with the environment that produced it
    (torch and CUDA versions, device, git SHA, timestamp)."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.json"
    with open(path, "w") as f:
        json.dump({"meta": run_metadata(), "rows": rows}, f, indent=2,
                  default=str)
    return path


#: row keys that hold a wall time or a ratio of wall times
WALL_KEYS = ("upd_txn_s", "scan_reads_s", "txn_s", "us_per_txn",
             "rmw_ops_s", "wall_s", "tok_s", "txn_s_vs_drop",
             "txn_s_vs_budget", "pipelined_over_barriered")
#: float row fields, compared to rtol 1e-6 (float32 means and fractions
#: may be summed in another order)
FLOAT_KEYS = ("scan_found_frac", "found_rate", "occ_mean",
              "found_vs_drop", "found_vs_budget")


def is_wall_key(key: str) -> bool:
    return key in WALL_KEYS or key.endswith("_us")


def row_mismatches(want: List[Dict], got: List[Dict],
                   skip=()) -> List[str]:
    """Where two runs' rows differ in a field that is not a wall time (nor
    in ``skip``): the same keys in the same order, integers, strings and
    flags equal, ``FLOAT_KEYS`` to rtol 1e-6. Empty when they agree."""
    if len(want) != len(got):
        return [f"{len(want)} rows != {len(got)}"]
    bad = []
    for i, (w, g) in enumerate(zip(want, got)):
        if list(w) != list(g):
            bad.append(f"row {i}: keys {list(w)} != {list(g)}")
            continue
        for k, v in w.items():
            if is_wall_key(k) or k in skip:
                continue
            if k in FLOAT_KEYS and v != "":
                ok = abs(g[k] - v) <= 1e-6 * abs(v)
            else:
                ok = g[k] == v and isinstance(g[k], bool) == \
                    isinstance(v, (bool, np.bool_))
            if not ok:
                bad.append(f"row {i}: {k} {g[k]!r} != {v!r}")
    return bad


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def needs_cuda(script: str) -> bool:
    """False (with a message) where no CUDA device is visible: the
    benchmarks measure the card and exit 2 without one."""
    if torch.cuda.is_available():
        return True
    print(f"{script}: needs a CUDA device", file=sys.stderr)
    return False


def round_table(rows: List[Dict]) -> List[str]:
    """One line per row: committed txn/s beside the protocol's serial
    steps over the timed stream (rounds for the baselines, waves for
    Bohm) and the wall ms each took."""
    out = []
    for r in rows:
        proxy = dict(kv.split("=", 1) for kv in r["proxy"].split())
        steps = int(proxy.get("rounds", proxy.get("waves", 0)))
        unit = "waves" if "waves" in proxy else "rounds"
        per = f"{r['time_s'] * 1e3 / steps:.3f}" if steps else "-"
        out.append(f"{r['cell']:<26} {r['protocol']:<8} "
                   f"{r['txn_s']:>12.1f} txn/s  {steps:>6} {unit:<6} "
                   f"{per:>8} ms each  abort_rate {r['abort_rate']}  "
                   f"{r['verdict']}")
    return out
