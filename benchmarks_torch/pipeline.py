"""Pipelined transaction service on the card — paper §3 / Fig 3 overlap
(the counterpart of ``benchmarks/pipeline.py``).

    python3 benchmarks_torch/pipeline.py [--quick]

An update stream (YCSB 10RMW) runs through ``repro_torch.service.
TxnService`` at 1, 2 and 4 store shards, pipelined (CC(b+1) dispatched
while exec(b) is in flight, host joins only at the end) against
barriered (a host join every batch). Reported per cell, in the
reference's schema: ``txn_s`` and ``us_per_txn`` over the timed stream
(best pass), ``planned_ahead_max``, and a ``speedup`` row of pipelined
over barriered per shard count.

Logical shards only (``substrate`` is always ``"logical"``: shards of
one device, byte-equal to one store); the reference's ``mesh`` rows need
the port's ``mesh=`` path (ROADMAP.md, queue 1 item 4). The reference's
points, seed (``default_rng(31)``) and sizes: 8192 records, ring 8,
batches of 256 at theta 0.6; ``quick`` runs 3 batches and 3 passes.
Needs a GPU; ``run(device="cpu")`` is the rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import card_line, needs_cuda, write_csv  # noqa: E402
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.workloads import gen_ycsb_batch, make_ycsb  # noqa: E402
from repro_torch.service import TxnService  # noqa: E402

N_RECORDS = 8192
BATCH = 256
N_BATCHES = 8
RING_SLOTS = 8


def bench_shards(n_shards: int, rng, n_batches: int, n_passes: int,
                 device=None) -> list:
    """Both modes at one shard count, stream passes INTERLEAVED
    (barriered, pipelined, barriered, ...) so slow machine drift hits
    both modes equally; best pass per mode is reported."""
    wl = make_ycsb(payload_words=2)
    batches = [gen_ycsb_batch(rng, BATCH, N_RECORDS, theta=0.6,
                              mix="10rmw", device=device)
               for _ in range(n_batches + 1)]
    svcs, times = {}, {}
    for pipelined in (False, True):
        eng = BohmEngine(N_RECORDS, wl, n_shards=n_shards,
                         ring_slots=RING_SLOTS, device=device)
        svc = TxnService(eng, max_inflight=2, pipelined=pipelined)
        svc.submit(batches[0])    # warm both phases outside the timing
        svc.drain()
        svcs[pipelined] = svc
        times[pipelined] = []
    for i in range(n_passes):     # store keeps rolling between passes
        order = (False, True) if i % 2 == 0 else (True, False)
        for pipelined in order:   # alternate order: no who-runs-first bias
            svc = svcs[pipelined]
            t0 = time.perf_counter()
            svc.submit_many(batches[1:])
            svc.drain()
            times[pipelined].append(time.perf_counter() - t0)

    n_txn = n_batches * BATCH
    rows = []
    for pipelined in (False, True):
        dt = min(times[pipelined])
        rows.append({
            "n_shards": n_shards,
            "mode": "pipelined" if pipelined else "barriered",
            "substrate": "logical",
            "batch": BATCH,
            "txn_s": round(n_txn / dt),
            "us_per_txn": round(1e6 * dt / n_txn, 2),
            "planned_ahead_max": svcs[pipelined].stats[
                "planned_ahead_max"],
            "pipelined_over_barriered": "",
        })
    rows.append({
        "n_shards": n_shards, "mode": "speedup",
        "substrate": "logical", "batch": BATCH,
        "txn_s": "", "us_per_txn": "", "planned_ahead_max": "",
        "pipelined_over_barriered": round(
            min(times[False]) / min(times[True]), 3),
    })
    return rows


def run(quick: bool = False, device=None) -> list:
    rng = np.random.default_rng(31)
    n_batches = 3 if quick else N_BATCHES
    n_passes = 3 if quick else 5
    rows = []
    for n_shards in (1, 2, 4):
        rows.extend(bench_shards(n_shards, rng, n_batches, n_passes,
                                 device))
    write_csv("pipeline", rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="3 batches and 3 passes instead of 8 and 5")
    args = ap.parse_args()
    if not needs_cuda("pipeline"):
        return 2
    run(args.quick)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
