"""SmallBank on the card — paper §5.3, Figures 8 (full mix, 100
customers), 9 (read-only Balance mix), 10 (read-only vs contention) (the
counterpart of ``benchmarks/smallbank.py``).

    python3 benchmarks_torch/smallbank.py [--no-sweep]

Contention is controlled by the number of customers (fewer customers =
hotter accounts): 100, then the sweep over 25, 1,000, 10,000 and 100,000.
Driven through the port's arena adapters: all five protocols (plus the
conflict-aware Bohm scheduler) stream the same seeded batches
(``default_rng(13)``, 4 batches of 2048) per cell; rows are the
reference's long format plus its ``customers`` column, written as the
JSON twin ``benchmarks_torch/results/smallbank.json``. Stores open every
account at balance 1000, so TransactSaving's overdraft-abort branch
stays live (the workload-logic abort path, distinct from CC aborts).
Then one line a row with rounds or waves and the wall ms each took, and
the card's name and power limit. Needs a GPU; ``run(device="cpu")`` is
the rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import (card_line, needs_cuda,  # noqa: E402
                                     round_table, write_csv)
from repro_torch.arena import ArenaCell, make_protocols, run_cell  # noqa: E402
from repro_torch.core.workloads import (gen_smallbank_batch,  # noqa: E402
                                        make_smallbank)
from repro_torch.obs import MetricsRegistry  # noqa: E402

BATCH = 2048
N_BATCHES = 4
FULL_MIX = (0.2, 0.2, 0.2, 0.2, 0.2)
BALANCE_ONLY = (1.0, 0.0, 0.0, 0.0, 0.0)


def bench_cell(n_customers: int, mix, label: str, rng, protos,
               base, device="cuda") -> list:
    n_records = max(2 * n_customers, 2)
    cell = ArenaCell(
        f"smallbank-{label}-c{n_customers}", "smallbank", n_records,
        [gen_smallbank_batch(rng, BATCH, n_customers, mix=mix,
                             device=device)
         for _ in range(N_BATCHES)], mix=label)
    rows = run_cell(cell, protos, iters=2, base=base)
    for r in rows:
        r["customers"] = n_customers
    return rows


def run(sweep_customers: bool = True, device="cuda") -> list:
    rng = np.random.default_rng(13)
    registry = MetricsRegistry()
    rows = []
    sizes = [100] + ([25, 1000, 10_000, 100_000] if sweep_customers
                     else [])
    for n in sizes:
        # one protocol set per store size (shapes change with R)
        protos = make_protocols(max(2 * n, 2), make_smallbank(), registry,
                                device=device)
        # accounts start at 1000 (paper setup): overdraft aborts stay rare
        # but reachable
        base = torch.full((max(2 * n, 2), 2), 1000, dtype=torch.int32,
                          device=device)
        rows.extend(bench_cell(n, FULL_MIX, "full", rng, protos, base,
                               device))
        rows.extend(bench_cell(n, BALANCE_ONLY, "balance", rng, protos,
                               base, device))
    write_csv("smallbank", rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-sweep", action="store_true",
                    help="100 customers only (skip the contention sweep)")
    args = ap.parse_args()
    if not needs_cuda("smallbank"):
        return 2
    rows = run(sweep_customers=not args.no_sweep)
    print("\n".join(round_table(rows)))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
