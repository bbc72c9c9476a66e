"""Snapshot reads on the card — the paper's Fig 9/10 scenario (the
counterpart of ``benchmarks/snapshot.py``): a stream of update batches
(SmallBank full mix / YCSB 10RMW) beside long-running read-only scans at
an OLDER snapshot.

    python3 benchmarks_torch/snapshot.py [--num-records N]

Bohm's headline: reads never block writes and perform zero bookkeeping.
Each cell streams ``N_BATCHES`` update batches while a reader pinned at
the pre-stream snapshot scans records through ``mvcc_resolve`` and
``mvcc_resolve_masked`` (the default engine has the spill tier on), both
reading the store in place. Reported per cell, in the reference's
schema:

  upd_txn_s        update-batch transaction throughput
  scan_reads_s     snapshot-read throughput (resolved reads / second)
  scan_found_frac  fraction of scan reads whose version survived (1.0 =
                   the pinned snapshot stayed fully readable)
  occ_max/mean     ring occupancy after the stream
  evicted/overwrote  GC + overflow counters of the final batch

The reference's points, seed (``default_rng(29)``, one generator shared
by the four cells in ``run()``'s order) and sizes: 8192 records, batches
of 512, 256 scans x 8 reads, ring 8, 2-word YCSB payloads at theta 0.6.
``num_records`` scales the record count (the card's scale is 1,000,000);
SmallBank keeps the reference's 4,096 customers at every scale, since the
customer count sets its contention. Each batch's ``found_frac`` stays on
the device inside the timed loop and is read after the fence. Needs a
GPU; ``run(device="cpu")`` is the rehearsal on the CPU.
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
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.workloads import (gen_scan_batch,  # noqa: E402
                                        gen_smallbank_batch, gen_ycsb_batch,
                                        make_smallbank, make_ycsb)

N_RECORDS = 8192
BATCH = 512
SCAN_TXNS = 256
SCAN_OPS = 8
N_BATCHES = 8
RING_SLOTS = 8
SMALLBANK_CUSTOMERS = N_RECORDS // 2    # the reference's, at every scale


def _update_batches(kind: str, rng, num_records: int, device):
    if kind == "smallbank":
        wl = make_smallbank()
        batches = [gen_smallbank_batch(rng, BATCH, SMALLBANK_CUSTOMERS,
                                       device=device)
                   for _ in range(N_BATCHES)]
    else:
        wl = make_ycsb(payload_words=2)
        batches = [gen_ycsb_batch(rng, BATCH, num_records, theta=0.6,
                                  mix="10rmw", device=device)
                   for _ in range(N_BATCHES)]
    return wl, batches


def bench_cell(kind: str, pinned: bool, rng, num_records: int = N_RECORDS,
               device=None, probe=None) -> dict:
    """One cell. A dict passed as ``probe`` receives the state at the pin
    (``at_pin``, copied before the timed loop) and every scan's batch,
    values and found flags (``scans``), which the loop keeps on the
    device, for a caller that checks the pinned reads."""
    wl, batches = _update_batches(kind, rng, num_records, device)
    eng = BohmEngine(num_records, wl, ring_slots=RING_SLOTS, device=device)
    scans = [gen_scan_batch(rng, SCAN_TXNS, num_records, ops=SCAN_OPS,
                            device=device) for _ in range(2)]

    # warm-up both paths outside the timed region
    eng.run_batch(batches[0])
    eng.run_readonly_batch(scans[0])
    snap = eng.begin_snapshot() if pinned else None
    if probe is not None:
        probe["at_pin"] = eng.snapshot().clone()
        probe["scans"] = []

    t0 = time.perf_counter()
    metrics = None
    found = []
    for i, batch in enumerate(batches[1:]):
        _, metrics = eng.run_batch(batch)
        scan = scans[i % len(scans)]
        vals, fnd, sm = eng.run_readonly_batch(scan, snap)
        found.append(sm["found_frac"])    # stays on device: no sync in loop
        if probe is not None:
            probe["scans"].append((scan, vals, fnd))
    device_mod.fence(eng.store.base)
    dt = time.perf_counter() - t0
    found = [float(f) for f in found]

    n_upd = (N_BATCHES - 1) * BATCH
    n_reads = (N_BATCHES - 1) * SCAN_TXNS * SCAN_OPS
    row = {
        "workload": kind, "pinned_reader": pinned,
        "upd_txn_s": round(n_upd / dt),
        "scan_reads_s": round(n_reads / dt),
        "scan_found_frac": round(min(found), 4),
        "occ_max": int(metrics["ring_occ_max"]),
        "occ_mean": round(float(metrics["ring_occ_mean"]), 2),
        "evicted": int(metrics["ring_evicted"]),
        "overwrote_live": int(metrics["ring_overwrote_live"]),
    }
    if snap is not None:
        eng.release_snapshot(snap)
    return row


def run(num_records: int = N_RECORDS, device=None) -> list:
    rng = np.random.default_rng(29)
    rows = []
    for kind in ("smallbank", "ycsb"):
        for pinned in (False, True):
            rows.append(bench_cell(kind, pinned, rng, num_records, device))
    write_csv("snapshot", rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-records", type=int, default=N_RECORDS)
    args = ap.parse_args()
    if not needs_cuda("snapshot"):
        return 2
    run(args.num_records)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
