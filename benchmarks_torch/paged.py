"""Paged physical version storage on the card — slab against dense
footprint (the counterpart of ``benchmarks/paged.py``).

    python3 benchmarks_torch/paged.py [--quick]

The hot/cold spill stream (same generator, pins and sweep cadence as
``benchmarks_torch/spill.py``) runs against three storage configs that
answer one question: what does a unit of PHYSICAL memory buy?

  dense_kmax    adaptive dense rings at k_max physical slots per record;
  dense_budget  dense rings at exactly the slot budget (k = RING_SLOTS);
  paged         the page slab at the SAME physical budget as
                dense_budget (R x RING_SLOTS slots): cold records hold
                one page, the freed pages let hot records grow toward
                k_max (page-table maintenance and free-list allocation
                inside the timed region).

Reported per cell, in the reference's schema: physical footprint (slots
and words, page tables included), slab occupancy / free pages /
allocation failures, found rate of historical reads at the held pins and
txn/s over the timed stream. The paged probe reads launch
``mvcc_resolve_paged`` over the page table in place, then
``mvcc_resolve_masked``. The reference's points, seed
(``default_rng(67)``) and sizes; ``quick`` trims timing passes only.
Needs a GPU; ``run(device="cpu")`` is the rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import card_line, needs_cuda, write_csv  # noqa: E402
from benchmarks_torch.spill import (BATCH, N_BATCHES,  # noqa: E402
                                    N_RECORDS, _hotset_batch, found_rate,
                                    timed_passes)

RING_SLOTS = 4
K_MAX = 16
PAGE_SLOTS = 2
SPILL_BUCKETS = 32
SPILL_SLOTS = 2

CONFIGS = (
    ("dense_kmax", dict(ring_slots=RING_SLOTS, adaptive_k=True,
                        k_max=K_MAX, spill_buckets=SPILL_BUCKETS,
                        spill_slots=SPILL_SLOTS)),
    ("dense_budget", dict(ring_slots=RING_SLOTS,
                          spill_buckets=SPILL_BUCKETS,
                          spill_slots=SPILL_SLOTS)),
    ("paged", dict(ring_slots=RING_SLOTS, adaptive_k=True, k_max=K_MAX,
                   paged=True, page_slots=PAGE_SLOTS,
                   pages_per_shard=N_RECORDS * RING_SLOTS // PAGE_SLOTS,
                   spill_buckets=SPILL_BUCKETS,
                   spill_slots=SPILL_SLOTS)),
)


def bench_config(name: str, kw: dict, batches, n_passes: int,
                 device=None) -> dict:
    eng, pins, times = timed_passes(kw, batches, n_passes, device)
    n_txn = len(batches) * BATCH
    dt = min(times)
    storage = eng.storage_stats()
    k = eng.k_by_record().cpu().numpy()
    row = {
        "config": name,
        "phys_slots": storage["physical_slots"],
        "phys_kwords": round(storage["physical_version_words"] / 1000),
        "dense_equiv_kwords": round(storage["dense_equiv_words"] / 1000),
        "slot_occupancy": storage["slot_occupancy"],
        "found_rate": round(found_rate(eng, pins), 4),
        "txn_s": round(n_txn / dt),
        "us_per_txn": round(1e6 * dt / n_txn, 2),
        "k_min_eff": int(k.min()),
        "k_max_eff": int(k.max()),
        "spill_dropped": eng.spill_stats()["spill_dropped"],
    }
    if storage["layout"] == "paged":
        row.update(pages_mapped=storage["pages_mapped"],
                   pages_free=storage["pages_free"],
                   alloc_failed=storage["alloc_failed"])
    else:
        row.update(pages_mapped=0, pages_free=0, alloc_failed=0)
    return row


def run(quick: bool = False, device=None) -> list:
    rng = np.random.default_rng(67)
    # quick trims TIMING passes only — found_rate needs the full stream
    n_passes = 1 if quick else 4
    batches = [_hotset_batch(rng, device) for _ in range(N_BATCHES)]
    rows = [bench_config(name, kw, batches, n_passes, device)
            for name, kw in CONFIGS]
    base = next(r for r in rows if r["config"] == "dense_budget")
    for r in rows:
        r["found_vs_budget"] = round(r["found_rate"]
                                     / max(base["found_rate"], 1e-9), 3)
        r["txn_s_vs_budget"] = round(r["txn_s"] / base["txn_s"], 3)
        r["words_vs_budget"] = round(r["phys_kwords"]
                                     / max(base["phys_kwords"], 1), 3)
    write_csv("paged", rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="1 timed pass a config instead of 4")
    args = ap.parse_args()
    if not needs_cuda("paged"):
        return 2
    run(args.quick)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
