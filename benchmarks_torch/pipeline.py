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

``substrate`` is ``"mesh"`` for 1 < n <= the visible cards: the
engine runs ``BohmEngine(mesh=)`` on an n-rank ``cc`` mesh, one process a
card over NCCL (``common.spawn_ranks``), every rank driving the same
service; rank 0's times are reported. Otherwise it is ``"logical"``
(shards of one device, byte-equal to one store) — the reference's rule,
so one card gives the logical rows alone. The reference's points, seed
(``default_rng(31)``) and sizes: 8192 records, ring 8, batches of 256 at
theta 0.6; ``quick`` runs 3 batches and 3 passes. Needs a GPU;
``run(device="cpu")`` is the rehearsal on the CPU (``cards=`` and
``launch=`` rehearse the mesh rows over ranks that run as threads).
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

import functools  # noqa: E402

from benchmarks_torch.common import (card_line, needs_cuda,  # noqa: E402
                                     spawn_ranks, visible_cards, write_csv)
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.txn import make_batch  # noqa: E402
from repro_torch.core.workloads import gen_ycsb_batch, make_ycsb  # noqa: E402
from repro_torch.service import TxnService  # noqa: E402

N_RECORDS = 8192
BATCH = 256
N_BATCHES = 8
RING_SLOTS = 8


def bench_shards(n_shards: int, rng, n_batches: int, n_passes: int,
                 device=None, cards: int = 1, launch=None) -> list:
    """Both modes at one shard count (on an n-rank mesh where the cards
    allow); see ``stream_rows``."""
    arrays = [tuple(x.cpu().numpy() for x in (
        b.read_set, b.write_set, b.txn_type, b.args))
        for b in (gen_ycsb_batch(rng, BATCH, N_RECORDS, theta=0.6,
                                 mix="10rmw", device="cpu")
                  for _ in range(n_batches + 1))]
    fn = functools.partial(stream_rows, n_shards=n_shards, arrays=arrays,
                           n_passes=n_passes, device=device,
                           n_records=N_RECORDS, batch=BATCH)
    if 1 < n_shards <= cards:
        return (launch or spawn_ranks)(fn, n_shards, device)[0]
    return fn(None)


def stream_rows(mesh, n_shards: int, arrays, n_passes: int, device=None,
                n_records: int = N_RECORDS, batch: int = BATCH) -> list:
    """Both modes at one shard count, stream passes INTERLEAVED
    (barriered, pipelined, barriered, ...) so slow machine drift hits
    both modes equally; best pass per mode is reported. With ``mesh``
    every rank runs this over the mesh's engines."""
    wl = make_ycsb(payload_words=2)
    n_batches = len(arrays) - 1
    batches = [make_batch(*a, device=device) for a in arrays]
    svcs, times = {}, {}
    for pipelined in (False, True):
        eng = BohmEngine(n_records, wl, mesh=mesh, n_shards=n_shards,
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

    n_txn = n_batches * batch
    substrate = "logical" if mesh is None else "mesh"
    rows = []
    for pipelined in (False, True):
        dt = min(times[pipelined])
        rows.append({
            "n_shards": n_shards,
            "mode": "pipelined" if pipelined else "barriered",
            "substrate": substrate,
            "batch": batch,
            "txn_s": round(n_txn / dt),
            "us_per_txn": round(1e6 * dt / n_txn, 2),
            "planned_ahead_max": svcs[pipelined].stats[
                "planned_ahead_max"],
            "pipelined_over_barriered": "",
        })
    rows.append({
        "n_shards": n_shards, "mode": "speedup",
        "substrate": substrate, "batch": batch,
        "txn_s": "", "us_per_txn": "", "planned_ahead_max": "",
        "pipelined_over_barriered": round(
            min(times[False]) / min(times[True]), 3),
    })
    return rows


def run(quick: bool = False, device=None, cards=None, launch=None) -> list:
    """``cards`` (default: the visible cards, 1 on the CPU) decides which
    shard counts run on a mesh; ``launch(fn, n, device)`` runs ``fn(mesh)``
    on an n-rank mesh and returns the ranks' results (default
    ``common.spawn_ranks``); rank 0's rows are written."""
    rng = np.random.default_rng(31)
    n_batches = 3 if quick else N_BATCHES
    n_passes = 3 if quick else 5
    cards = visible_cards(device) if cards is None else cards
    rows = []
    for n_shards in (1, 2, 4):
        rows.extend(bench_shards(n_shards, rng, n_batches, n_passes,
                                 device, cards, launch))
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
