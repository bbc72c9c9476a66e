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

Only the ``cc_shards=1`` column: the reference's other columns plan
through ``cc_plan_sharded`` over a mesh, which waits for the port's
``mesh=`` path (ROADMAP.md, queue 1 item 4). The reference's seed
(``default_rng(3)``) and sizes. No kernel runs here: the write path is
plain PyTorch on the card. Needs a GPU; ``run(device="cpu")`` is the
rehearsal on the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import (card_line, needs_cuda,  # noqa: E402
                                     time_fn, write_csv)
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.workloads import gen_ycsb_batch, make_microbench  # noqa: E402

N_RECORDS = 1_000_000
OPS = 10


def run(batch_sizes=(256, 512, 1024, 2048), device=None) -> list:
    rng = np.random.default_rng(3)
    wl = make_microbench()
    rows = []
    for batch_size in batch_sizes:
        eng = BohmEngine(N_RECORDS, wl, device=device)
        batch = gen_ycsb_batch(rng, batch_size, N_RECORDS, theta=0.0,
                               mix="10rmw", device=device)
        _, metrics = eng.run_batch(batch)
        t = time_fn(eng._step, eng.store, batch)
        rows.append({
            "cc_shards": 1, "batch": batch_size,
            "txn_s": round(batch_size / t),
            "rmw_ops_s": round(batch_size * OPS / t),
            "waves": int(metrics["waves"]),
            "us_per_txn": round(1e6 * t / batch_size, 2),
        })
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
