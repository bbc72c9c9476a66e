"""Out-of-order admission on the port: reordering against FIFO-prefix
merging (the counterpart of ``benchmarks/admission.py``).

    python3 benchmarks_torch/admission.py [--quick]

The reference's streams, cells, shapes and row schema over the port's
``TxnService`` on the card:

  disjoint_cold   YCSB 10-RMW batches round robin over 4 disjoint key
                  stripes — the merge/chain best case;
  mixed           short 4-RMW batches over 8 stripes carved from
                  [R/16, R), a 3-batch burst on one of 3 contended
                  stripes every 8 batches (the head-of-line case);
  latency_class   bulk full-range batches with an interactive point
                  batch every 6 admissions on the reserved range: per
                  class p50/p99 ticket latency since the burst started.

8192 records, ring_slots=8, 2-word payloads, batches of 64, 24 batches a
stream, built on the host. Cells: ``barriered`` (``pipelined=False``,
window 1), ``fifo_w2`` / ``fifo_w4`` (``reorder=False``) and ``ooo``
(``max_inflight=4, admission_window=16, max_inflight_execs=4``). Each cell runs one untimed
warm pass, then ``n_passes`` timed passes in alternating cell order on a
store that keeps rolling; a row holds the best pass and one pass's
scheduler counters: ``txn_s``, ``us_per_txn``, ``merged_batches``,
``hopped_batches``, ``overlapped_execs``, ``chain_depth_max``,
``window_occupancy``, ``vs_barriered`` and ``vs_fifo4``. Prints the rows
as a table, then one JSON object with the rows, the device's name and
``nvidia-smi``'s power limit; the JSON twins ``admission.json`` and
``admission_latency.json`` go to ``benchmarks_torch/results/``. Needs a
GPU; ``run(device="cpu")`` is the rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import write_csv  # noqa: E402
from chip_smoke import OOO_KW, mixed_stream, span_batch  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.workloads import make_ycsb  # noqa: E402
from repro_torch.service import TxnService  # noqa: E402

N_RECORDS, BATCH, N_BATCHES, RING_SLOTS = 8192, 64, 24, 8
N_STRIPES = 4          # disjoint_cold: 4 stripes over the key space
HOT_RANGE = N_RECORDS // 16
MIX_OPS = 4            # mixed: short update transactions
INTER_T, INTER_OPS, INTER_EVERY = 16, 2, 6
CELLS = [
    ("barriered", dict(max_inflight=2, pipelined=False, admission_window=1)),
    ("fifo_w2", dict(max_inflight=2, admission_window=2, reorder=False)),
    ("fifo_w4", dict(max_inflight=2, admission_window=4, reorder=False)),
    ("ooo", dict(**OOO_KW)),
]
LAT_CELLS = [
    ("barriered", dict(max_inflight=2, pipelined=False, admission_window=1)),
    ("fifo_w4", dict(max_inflight=32, admission_window=4, reorder=False)),
    ("ooo", dict(max_inflight=32, admission_window=8, max_inflight_execs=4)),
]
DECISION_KEYS = ("merged_batches", "overlapped_execs", "hopped_batches",
                 "class_promotions", "chain_depth_max")


def _stream(rng, kind: str):
    if kind == "mixed":
        return mixed_stream(rng, N_RECORDS, N_BATCHES, BATCH, MIX_OPS)
    width = N_RECORDS // N_STRIPES
    return [span_batch(rng, (i % N_STRIPES) * width,
                       (i % N_STRIPES + 1) * width, 10, BATCH)
            for i in range(N_BATCHES)]


def _engine(device):
    return BohmEngine(N_RECORDS, make_ycsb(payload_words=2),
                      ring_slots=RING_SLOTS, device=device)


def bench_stream(kind: str, rng, n_passes: int, device) -> list:
    batches = _stream(rng, kind)
    svcs, times = {}, {}
    for name, kw in CELLS:
        svc = TxnService(_engine(device), **kw)
        svc.submit_many(batches)           # untimed warm pass
        svc.drain()
        svcs[name], times[name] = svc, []
    for i in range(n_passes):              # the store keeps rolling
        order = CELLS if i % 2 == 0 else CELLS[::-1]
        for name, _ in order:              # alternate: no drift bias
            svc = svcs[name]
            svc.stats.update({k: 0 for k in DECISION_KEYS})
            t0 = time.perf_counter()
            svc.submit_many(batches)
            svc.drain()
            times[name].append(time.perf_counter() - t0)
    n_txn = N_BATCHES * BATCH
    base_dt, fifo_dt = min(times["barriered"]), min(times["fifo_w4"])
    rows = []
    for name, kw in CELLS:
        dt, st = min(times[name]), svcs[name].stats
        rows.append({
            "stream": kind, "mode": name,
            "admission_window": kw.get("admission_window", 1),
            "batch": BATCH,
            "txn_s": round(n_txn / dt),
            "us_per_txn": round(1e6 * dt / n_txn, 2),
            "merged_batches": st["merged_batches"],
            "hopped_batches": st["hopped_batches"],
            "overlapped_execs": st["overlapped_execs"],
            "chain_depth_max": st["chain_depth_max"],
            "window_occupancy": st["admission_window_occupancy"],
            "vs_barriered": round(base_dt / dt, 3),
            "vs_fifo4": round(fifo_dt / dt, 3),
        })
    return rows


def _latency_stream(rng):
    out = []
    for i in range(N_BATCHES):
        if i % INTER_EVERY == INTER_EVERY - 1:
            out.append((span_batch(rng, 0, HOT_RANGE, INTER_OPS, INTER_T),
                        "interactive"))
        else:
            out.append((span_batch(rng, HOT_RANGE, N_RECORDS, 10, BATCH),
                        "bulk"))
    return out


def _latency_pass(svc, stream):
    """Burst-submit the stream and record each ticket's completion time
    since the burst started; pending interactive tickets are polled after
    every submit (``benchmarks/admission.py``'s ``_run_latency_pass``)."""
    t0 = time.perf_counter()
    pending, lats = {}, {"interactive": [], "bulk": []}

    def sweep(only_interactive):
        for t in sorted(pending):
            if only_interactive and pending[t] != "interactive":
                continue
            res = svc.poll(t)
            if res is not None:
                device_mod.fence(res.read_vals)
                lats[pending.pop(t)].append(time.perf_counter() - t0)

    for batch, cls in stream:
        pending[svc.submit(batch, latency_class=cls)] = cls
        if any(c == "interactive" for c in pending.values()):
            sweep(only_interactive=True)
    while pending:
        sweep(only_interactive=False)
    svc.drain()
    return lats


def bench_latency(rng, n_passes: int, device) -> list:
    stream = _latency_stream(rng)
    n_txn = sum(b.size for b, _ in stream)
    rows = []
    for name, kw in LAT_CELLS:
        svc = TxnService(_engine(device), **kw)
        _latency_pass(svc, stream)         # warm pass
        best = None
        for _ in range(n_passes):
            t0 = time.perf_counter()
            lats = _latency_pass(svc, stream)
            dt = time.perf_counter() - t0
            if best is None or dt < best[0]:
                best = (dt, lats)
        dt, lats = best
        for cls in ("interactive", "bulk"):
            ms = 1e3 * np.asarray(lats[cls])
            rows.append({
                "stream": "latency_class", "mode": name, "class": cls,
                "n_tickets": len(ms),
                "p50_ms": round(float(np.percentile(ms, 50)), 3),
                "p99_ms": round(float(np.percentile(ms, 99)), 3),
                "max_ms": round(float(ms.max()), 3),
                "txn_s": round(n_txn / dt),
                "class_promotions": svc.stats["class_promotions"],
            })
    return rows


def _device_line(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def run(quick: bool = False, device="cuda") -> list:
    rng = np.random.default_rng(47)
    n_passes = 3 if quick else 5
    rows = []
    for kind in ("disjoint_cold", "mixed"):
        rows.extend(bench_stream(kind, rng, n_passes, device))
    write_csv("admission", rows, print_rows=False)
    lat_rows = bench_latency(rng, max(2, n_passes - 1), device)
    write_csv("admission_latency", lat_rows, print_rows=False)
    rows += lat_rows
    for r in rows:
        print(" ".join(f"{k}={v}" for k, v in r.items()))
    print(json.dumps({"device": _device_line(device), "rows": rows}))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="3 timed passes a cell instead of 5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("admission: needs a CUDA device", file=sys.stderr)
        return 2
    run(args.quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
