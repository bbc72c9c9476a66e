"""Concurrency-control microbenchmark on the card — paper §5.1, Figure 4
(the counterpart of ``benchmarks/microbench.py``).

    python3 benchmarks_torch/microbench.py

1,000,000 records, 10RMW transactions, uniform access, one batch per
batch size (256, 512, 1024, 2048; exec "threads" are the wavefront's
lanes, so the batch size is the x-axis). Each point runs the batch once
through ``run_batch`` (its ``waves``), then times ``BohmEngine._step``
(``bohm_step``: plan, exec and commit on the engine's store, which stays
as it was) with ``common.time_fn``, which joins the device each call.
Rows in the reference's schema: ``cc_shards``, ``batch``, ``txn_s``,
``rmw_ops_s``, ``waves``, ``us_per_txn``.

The CC-thread lines are ``cc_shards`` 1, 2, 4 and 8: a column of n > 1
runs ``BohmEngine(mesh=)`` on an n-rank ``cc`` mesh, one process a card
over NCCL (``common.spawn_ranks``; the CC phase planned record-
partitioned, the store sharded), and is written only where n cards are
visible — the reference's rule (n <= its devices), which also keeps the
seeded stream of the columns it runs. On one card that is the
``cc_shards=1`` column alone. The reference's seed (``default_rng(3)``)
and sizes. No kernel runs here: the write path is plain PyTorch on the
card. Needs a GPU; ``run(device="cpu")`` is the rehearsal on the CPU
(``cards=`` and ``launch=`` rehearse the mesh columns over ranks that
run as threads).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import functools  # noqa: E402

from benchmarks_torch.common import (card_line, needs_cuda,  # noqa: E402
                                     spawn_ranks, time_fn, visible_cards,
                                     write_csv)
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.txn import make_batch  # noqa: E402
from repro_torch.core.workloads import gen_ycsb_batch, make_microbench  # noqa: E402

N_RECORDS = 1_000_000
OPS = 10


def points(mesh, batches, n_cc: int, device=None,
           n_records: int = N_RECORDS) -> list:
    """One row a batch (numpy (read_set, write_set, txn_type, args)):
    ``run_batch`` once, then ``_step`` timed. With ``mesh`` every rank
    runs this and each of its engines plans and commits over the mesh."""
    wl = make_microbench()
    rows = []
    for arrays in batches:
        batch_size = len(arrays[0])
        eng = BohmEngine(n_records, wl, mesh=mesh, device=device)
        batch = make_batch(*arrays, device=device)
        _, metrics = eng.run_batch(batch)
        t = time_fn(eng._step, eng.store, batch)
        rows.append({
            "cc_shards": n_cc, "batch": batch_size,
            "txn_s": round(batch_size / t),
            "rmw_ops_s": round(batch_size * OPS / t),
            "waves": int(metrics["waves"]),
            "us_per_txn": round(1e6 * t / batch_size, 2),
        })
    return rows


def run(cc_shards=(1, 2, 4, 8), batch_sizes=(256, 512, 1024, 2048),
        device=None, cards=None, launch=None) -> list:
    """The rows of every ``cc_shards`` column that ``cards`` (default: the
    visible cards, 1 on the CPU) allow. ``launch(fn, n, device)`` runs
    ``fn(mesh)`` on an n-rank mesh and returns the ranks' results
    (default ``common.spawn_ranks``); rank 0's rows are written."""
    rng = np.random.default_rng(3)
    cards = visible_cards(device) if cards is None else cards
    launch = launch or spawn_ranks
    rows = []
    for n_cc in cc_shards:
        if n_cc > cards:
            continue
        batches = [tuple(x.cpu().numpy() for x in (
            b.read_set, b.write_set, b.txn_type, b.args))
            for b in (gen_ycsb_batch(rng, batch_size, N_RECORDS, theta=0.0,
                                     mix="10rmw", device="cpu")
                      for batch_size in batch_sizes)]
        fn = functools.partial(points, batches=batches, n_cc=n_cc,
                               device=device, n_records=N_RECORDS)
        rows.extend(fn(None) if n_cc == 1 else launch(fn, n_cc, device)[0])
    write_csv("microbench", rows)
    return rows


def main() -> int:
    if not needs_cuda("microbench"):
        return 2
    run()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
