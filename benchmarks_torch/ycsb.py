"""YCSB on the card — paper §5.2, Figures 5 (low contention), 6
(theta=0.9), 7 (2RMW-8R vs theta): Bohm vs 2PL / Hekaton / OCC / SI (the
counterpart of ``benchmarks/ycsb.py``).

    python3 benchmarks_torch/ycsb.py [--no-sweep]

Driven through the port's arena adapters (``repro_torch.arena``): every
protocol streams the same seeded batches (``default_rng(7)``; 262,144
records, 8 payload words, 4 batches of 1024) at matched batch size; rows
are the reference's long format (one per cell x protocol: committed
throughput, abort rate, native cost proxies, the tag-replay
serializability verdict), written as the JSON twin
``benchmarks_torch/results/ycsb.json``. Then one line a row with the
rounds (baselines) or waves (Bohm) of the timed stream and the wall ms
each took — the baselines' txn/s on the card is their host's round
cost — and the card's name and power limit. Needs a GPU; ``run(device=
"cpu")`` is the rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import (card_line, needs_cuda,  # noqa: E402
                                     round_table, write_csv)
from repro_torch.arena import ArenaCell, make_protocols, run_cell  # noqa: E402
from repro_torch.core.workloads import gen_ycsb_batch, make_ycsb  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402

N_RECORDS = 262_144
BATCH = 1024
N_BATCHES = 4
PAYLOAD_WORDS = 8          # 32B payload stand-in for YCSB's 1000B records


def run(sweep_theta: bool = True, num_records: int = N_RECORDS,
        batch: int = BATCH, payload_words: int = PAYLOAD_WORDS,
        device="cuda") -> list:
    rng = np.random.default_rng(7)
    registry = MetricsRegistry()
    protos = make_protocols(num_records,
                            make_ycsb(payload_words=payload_words),
                            registry, device=device)

    # Fig 5 (low contention) + Fig 6 (high contention)
    points = [(theta, mix) for theta in (0.0, 0.9)
              for mix in ("10rmw", "2rmw8r")]
    if sweep_theta:                       # Fig 7: 2RMW-8R vs theta
        points += [(theta, "2rmw8r")
                   for theta in (0.5, 0.7, 0.8, 0.95, 0.99)]

    rows = []
    for theta, mix in points:
        cell = ArenaCell(
            f"ycsb-{mix}-z{theta:g}", "ycsb", num_records,
            [gen_ycsb_batch(rng, batch, num_records, theta=theta,
                            mix=mix, device=device)
             for _ in range(N_BATCHES)],
            theta=theta, mix=mix)
        rows.extend(run_cell(cell, protos, iters=2))
    write_csv("ycsb", rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-sweep", action="store_true",
                    help="Figs 5-6 only (skip the Fig 7 theta sweep)")
    args = ap.parse_args()
    if not needs_cuda("ycsb"):
        return 2
    rows = run(sweep_theta=not args.no_sweep)
    print("\n".join(round_table(rows)))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
