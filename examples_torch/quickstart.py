"""Quickstart: serializable multiversion transaction processing with Bohm,
on the PyTorch/CUDA port (the counterpart of ``examples/quickstart.py``).

Runs the paper's two-phase engine on a small YCSB-style workload, shows the
serializability guarantee against the serial oracle, demonstrates the
write-skew anomaly that Snapshot Isolation commits but Bohm excludes, and
runs a read-only scan against an OLDER snapshot while update batches
stream through (the cross-batch version ring + the ``mvcc_resolve``
read path).

    python3 examples_torch/quickstart.py [--device cpu]

Runs on the card by default; ``--device cpu`` takes the kernels' plain
PyTorch versions.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.baselines import run_si  # noqa: E402
from repro_torch.core.engine import BohmEngine, serial_oracle  # noqa: E402
from repro_torch.core.execute import init_store  # noqa: E402
from repro_torch.core.txn import Workload, make_batch  # noqa: E402
from repro_torch.core.workloads import (gen_scan_batch,  # noqa: E402
                                        gen_ycsb_batch, make_ycsb)
from repro_torch.device import resolve_device  # noqa: E402


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"quickstart: {what}")


def main(device=None):
    dev = resolve_device(device)
    # ------------------------------------------------------------------
    # 1. A contended YCSB batch through the two-phase engine
    # ------------------------------------------------------------------
    wl = make_ycsb()
    R = 10_000
    eng = BohmEngine(R, wl, ring_slots=16, device=dev)  # deep ring
    rng = np.random.default_rng(0)
    batch = gen_ycsb_batch(rng, 512, R, theta=0.9, mix="2rmw8r", device=dev)
    reads, metrics = eng.run_batch(batch)
    print(f"executed 512 txns in {int(metrics['waves'])} dependency waves "
          f"(reads never blocked writes; ww conflicts cost zero waves)")

    # serializability: identical to executing one-by-one in ts order
    base, serial_reads = serial_oracle(
        init_store(R, wl.payload_words, device=dev).base, batch, wl)
    _check(torch.equal(eng.snapshot(), base), "head store != serial")
    _check(torch.equal(reads, serial_reads), "reads != serial")
    print("result is bit-identical to the serial execution  [serializable]")

    # ------------------------------------------------------------------
    # 2. Write-skew: SI's famous anomaly vs Bohm
    # ------------------------------------------------------------------
    def no_abort(vals):
        return torch.zeros(vals.shape[0], dtype=torch.bool,
                           device=vals.device)

    def add_to_first(vals, args):
        out = vals.clone()
        out[:, 0, 0] += vals[:, 1, 0]
        return out, no_abort(vals)

    def add_to_second(vals, args):
        out = vals.clone()
        out[:, 1, 0] += vals[:, 0, 0]
        return out, no_abort(vals)

    skew = Workload("skew", 2, 2, 1, (add_to_first, add_to_second))
    batch = make_batch(np.array([[0, 1], [0, 1]]),
                       np.array([[0, -1], [-1, 1]]),
                       np.array([0, 1]), np.zeros((2, 1)), device=dev)
    base0 = torch.tensor([[3], [5]], dtype=torch.int32, device=dev)

    si_final, _, _ = run_si(base0, batch, skew, 2)
    eng2 = BohmEngine(2, skew, device=dev)
    eng2.reset_store(base0)
    eng2.run_batch(batch)
    serial_final, _ = serial_oracle(base0, batch, skew)
    print("\nwrite-skew (x=3, y=5; T0: x+=y, T1: y+=x):")
    print(f"  serial   -> {serial_final.tolist()}")
    print(f"  Bohm     -> {eng2.snapshot().tolist()}  (= serial)")
    print(f"  SI       -> {si_final.tolist()}  (NON-serializable!)")
    _check(torch.equal(eng2.snapshot(), serial_final), "Bohm != serial")

    # ------------------------------------------------------------------
    # 3. Snapshot reads: a long-running read-only scan at an OLD
    #    timestamp, concurrent with further update batches
    # ------------------------------------------------------------------
    snap = eng.begin_snapshot()          # pins the GC watermark at "now"
    state_then = eng.snapshot().clone()
    for _ in range(3):                   # updates keep streaming...
        eng.run_batch(gen_ycsb_batch(rng, 512, R, theta=0.0, mix="10rmw",
                                     device=dev))
    scan = gen_scan_batch(rng, 64, R, ops=10, device=dev)
    vals, found, m = eng.run_readonly_batch(scan, snap)   # ...reads don't
    #                                                       block, write
    #                                                       nothing, and
    #                                                       see the past
    _check(bool(found.all()), "a pinned read was not found")
    _check(torch.equal(vals, state_then[scan.read_set.long()]),
           "pinned reads != the pinned historical state")
    eng.release_snapshot(snap)           # lets the watermark advance
    print(f"\nsnapshot scan at ts={snap.ts} after 3 more batches: "
          f"640 reads, found_frac={float(m['found_frac']):.2f}, "
          f"all values = the pinned historical state  [snapshot reads]")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default the card; cpu for the plain versions")
    main(ap.parse_args().device)
