"""The port's benchmark harness: one suite per paper figure or table, on
the card (the counterpart of ``benchmarks/run.py``).

    python3 benchmarks_torch/run.py [--quick] [--only snapshot,pipeline]

  microbench  Fig 4   CC scalability over batch size; cc_shards 2/4/8 on
              a cc mesh where that many cards are visible
  ycsb        Fig 5-7 Bohm vs 2PL/Hekaton/OCC/SI, low/high contention
              + theta sweep
  smallbank   Fig 8-10 full mix + read-only vs contention
  snapshot    Fig 9/10 scenario: update stream + pinned snapshot scans
              through the version ring (occupancy, GC, scan survival)
  pipeline    §3/Fig 3 overlap: TxnService at 1/2/4 shards (a cc mesh
              where the cards allow, else logical), pipelined vs
              barriered
  admission   conflict-aware admission: merged CC epochs + exec-exec
              overlap vs the barriered baseline, hot/cold skewed streams
  spill       hierarchical version storage: fixed-K drop vs spill vs
              adaptive-K on a pinned hot-set update stream
  paged       paged physical storage: page slab vs dense rings on the
              same stream
  kernels     hand-written kernels vs their plain PyTorch versions
  serving     Bohm-MVCC paged KV serving engine, with and without
              prefix sharing
  arena       cross-protocol arena: all five protocols over the workload
              matrix at matched batch sizes + anomaly gauntlet

Each suite runs in this process on the card and writes its JSON twin to
``benchmarks_torch/results/`` (``summarize.py`` renders them,
``bench_history.py`` records their headline metrics). ``--quick`` skips
the slow sweep dimensions and trims timing passes; ``--only`` names a
subset (an unknown name is an error). Ends with the card's name and
power limit. Needs a GPU (exits 2 without one); each suite's
``run(device="cpu")`` is its rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import card_line, needs_cuda  # noqa: E402

# suite -> (banner, how run(quick) calls the suite's module.run)
SUITES = {
    "microbench": ("microbench (Fig 4)", lambda m, q: m.run()),
    "ycsb": ("ycsb (Figs 5-7)", lambda m, q: m.run(sweep_theta=not q)),
    "smallbank": ("smallbank (Figs 8-10)",
                  lambda m, q: m.run(sweep_customers=not q)),
    "snapshot": ("snapshot (Figs 9/10 scenario)", lambda m, q: m.run()),
    "pipeline": ("pipeline (Fig 3 overlap)", lambda m, q: m.run(q)),
    "admission": ("admission (conflict-aware scheduler)",
                  lambda m, q: m.run(q)),
    "spill": ("spill (hierarchical version storage)",
              lambda m, q: m.run(q)),
    "paged": ("paged (page-slab physical storage)", lambda m, q: m.run(q)),
    "kernels": ("kernels", lambda m, q: m.run()),
    "serving": ("serving", lambda m, q: m.run()),
    "arena": ("arena (cross-protocol matrix + gauntlet)",
              lambda m, q: m.run(quick=q)),
}


def run(only=None, quick: bool = False) -> None:
    """The named suites (default all), in the reference's order."""
    for name, (banner, call) in SUITES.items():
        if only is None or name in only:
            print(f"== {banner} ==", flush=True)
            call(importlib.import_module(f"benchmarks_torch.{name}"), quick)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="skip the slow sweep dimensions")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset: {','.join(SUITES)}")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None
    if only and only - set(SUITES):
        ap.error(f"unknown suites: {sorted(only - set(SUITES))}")
    if not needs_cuda("run"):
        return 2
    run(only, args.quick)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
