"""Protocol arena on the card — the paper's headline claim as one
cross-protocol run (the counterpart of ``benchmarks/arena.py``).

Every protocol (Bohm barriered, Bohm conflict-aware, Hekaton-pessimistic
MVCC, OCC, 2PL, SI) over the full workload matrix (YCSB uniform/zipfian
theta sweep, SmallBank, disjoint/mixed update streams, pinned snapshot
scans) at MATCHED batch sizes, plus the anomaly gauntlet, all through the
port's adapters on the GPU. One JSON twin
(``benchmarks_torch/results/arena.json``); every row carries committed
throughput, abort rate, the protocol's native cost proxies, and the
tag-replay MVSG serializability verdict.

The two claims checked after the run:
  * headline: on the most contended zipfian update stream the best Bohm
    variant sustains throughput >= Hekaton and OCC — printed, and a
    warning on miss (wall-clock, so noise must not fail the run);
  * gauntlet ground truth: SI (and only SI) flagged NON-SERIALIZABLE,
    exactly on the anomaly scenarios — asserted hard (deterministic).

Then one line a matrix row with the rounds (baselines) or waves (Bohm)
of the timed stream and the wall ms each took, and the card's name and
power limit.

    python3 benchmarks_torch/arena.py [--quick] [--protocols bohm,occ]

Needs a GPU (exits 2 without one); ``run(device="cpu")`` is the
rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import (card_line, needs_cuda,  # noqa: E402
                                     round_table, write_csv)
from repro_torch.arena import (PROTOCOL_NAMES, arena_matrix,  # noqa: E402
                               run_gauntlet, run_matrix)
from repro_torch.obs import MetricsRegistry  # noqa: E402


def markdown_pivot(rows: List[Dict]) -> str:
    """cells x protocols committed-throughput pivot + verdict flags
    (``!`` marks a NON-SERIALIZABLE verdict)."""
    protos = list(dict.fromkeys(r["protocol"] for r in rows))
    by_cell: Dict[str, Dict[str, str]] = defaultdict(dict)
    for r in rows:
        flag = "" if r["verdict"] == "serial-equivalent" else " !"
        by_cell[r["cell"]][r["protocol"]] = f"{r['txn_s']:.0f}{flag}"
    lines = ["| cell | " + " | ".join(protos) + " |",
             "|---|" + "---|" * len(protos)]
    for cell, vals in by_cell.items():
        lines.append("| " + cell + " | "
                     + " | ".join(vals.get(p, "-") for p in protos)
                     + " |")
    return "\n".join(lines)


def check_headline(rows: List[Dict]) -> bool:
    """Best Bohm variant >= Hekaton and OCC on the most contended
    zipfian 10RMW stream."""
    zipf = [r for r in rows
            if r["kind"] == "ycsb" and r["mix"] == "10rmw"
            and r["theta"] > 0]
    if not zipf:
        return True
    top = max(r["theta"] for r in zipf)
    cell = {r["protocol"]: r["txn_s"] for r in zipf
            if r["theta"] == top}
    bohm = max(cell.get("bohm", 0), cell.get("bohm-ca", 0))
    ok = all(bohm >= cell.get(b, 0) for b in ("hekaton", "occ"))
    print(f"\nheadline (ycsb-10rmw theta={top}): bohm={bohm:.0f} txn/s "
          f"vs hekaton={cell.get('hekaton', 0):.0f} "
          f"occ={cell.get('occ', 0):.0f} -> "
          + ("PASS" if ok else "MISS (wall-clock — inspect the twin)"))
    return ok


def check_gauntlet(rows: List[Dict]) -> None:
    bad = [r for r in rows if not r["as_expected"]]
    for r in bad:
        print(f"gauntlet UNEXPECTED: {r['cell']} / {r['protocol']}: "
              f"{r['verdict']} (expected serializable="
              f"{r['expected_serializable']})")
    if bad:
        raise SystemExit("anomaly gauntlet ground truth violated")
    flagged = sum(r["verdict"] != "serial-equivalent" for r in rows)
    print(f"gauntlet: {len(rows)} rows, {flagged} SI anomalies flagged, "
          "every serializable protocol certified -> PASS")


def run(quick: bool = False, iters: int = 2, seed: int = 0,
        protocols: Sequence[str] = PROTOCOL_NAMES,
        only_cells: Optional[Sequence[str]] = None,
        device="cuda") -> List[Dict]:
    registry = MetricsRegistry()
    cells = arena_matrix(quick, seed, device=device)
    if only_cells:
        cells = [c for c in cells if c.name in only_cells]
    rows = run_matrix(cells=cells, iters=iters, protocols=protocols,
                      registry=registry, device=device,
                      progress=lambda msg: print(f"  {msg}", flush=True))
    grows = run_gauntlet(protocols=protocols, registry=registry,
                         device=device)

    # one twin: matrix rows + gauntlet rows share the schema (matrix rows
    # get empty expectation columns so the CSV header is the union)
    for r in rows:
        r.setdefault("expected_serializable", "")
        r.setdefault("as_expected", "")
    all_rows = rows + grows
    write_csv("arena", all_rows, print_rows=False)

    cert = registry.view("arena/")
    if cert.get("certify_calls"):
        print(f"\ncertify cost: {cert['certify_calls']} calls / "
              f"{cert['certify_txns']} txns in "
              f"{cert['certify_wall_us'] / 1e3:.1f} ms "
              "(registry view arena/)")
    print("\n" + markdown_pivot(rows))
    check_headline(rows)
    check_gauntlet(grows)
    print("\n" + "\n".join(round_table(rows)))
    return all_rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="smaller store/batches, fewer theta points")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--protocols", default=None,
                    help=f"comma subset of {','.join(PROTOCOL_NAMES)}")
    ap.add_argument("--cells", default=None,
                    help="comma subset of matrix cell names")
    args = ap.parse_args()
    if not needs_cuda("arena"):
        return 2
    run(quick=args.quick, iters=args.iters, seed=args.seed,
        protocols=(args.protocols.split(",") if args.protocols
                   else PROTOCOL_NAMES),
        only_cells=args.cells.split(",") if args.cells else None)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
