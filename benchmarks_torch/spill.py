"""Hierarchical version storage on the card — spill rings + adaptive K
(the counterpart of ``benchmarks/spill.py``).

    python3 benchmarks_torch/spill.py [--quick]

A hot-set update stream (a stable set of hot records under moderate
per-record update rates, an active cold band, and an idle tail) runs
against three storage configs at the SAME primary slot budget (R x
RING_SLOTS effective slots) and, where present, the same small spill
pool:

  fixed_drop      fixed K, no spill: live history a hot record pushes
                  out of its ring is gone;
  fixed_spill     fixed K + spill pool: live evictions land in the
                  secondary tier and historical reads fall through;
  adaptive_spill  same budget + same spill, but ``gc_sweep`` reassigns
                  per-record capacity (``repro_torch/store/policy.py``).

Rolling snapshot pins model the paper's Fig 9/10 readers: a pin every
``PIN_EVERY`` batches, the oldest released beyond ``PINS_HELD``, and a
sweep at each pin. Reported per cell, in the reference's schema:
``found_rate`` (historical reads at the held pins over the hot + cold
band, read after the stream through ``mvcc_resolve`` and
``mvcc_resolve_masked``), ``txn_s`` / ``us_per_txn`` over the timed
stream (best pass; spill commit work and the sweep inside it), the
spill counters, live / dead evictions and the effective K spread.

The reference's points, seed (``default_rng(61)``), sizes and stream
(8192 records, 16 batches of 256 8-op transactions); ``quick`` trims
timing passes only. Needs a GPU; ``run(device="cpu")`` is the rehearsal
on the CPU.
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
from repro_torch.core.txn import make_batch  # noqa: E402
from repro_torch.core.workloads import make_ycsb  # noqa: E402

N_RECORDS = 8192
HOT_N = 512          # stable hot set: ~2 updates/record/batch
COLD_N = 4096        # active cold band: ~0.25 updates/record/batch
HOT_FRAC = 0.5       # fraction of writes aimed at the hot set
BATCH = 256
N_BATCHES = 16
OPS = 8
RING_SLOTS = 4
K_MAX = 16
SPILL_BUCKETS = 32
SPILL_SLOTS = 2
PIN_EVERY = 2
PINS_HELD = 3

CONFIGS = (
    ("fixed_drop", dict(ring_slots=RING_SLOTS, spill_slots=0)),
    ("fixed_spill", dict(ring_slots=RING_SLOTS,
                         spill_buckets=SPILL_BUCKETS,
                         spill_slots=SPILL_SLOTS)),
    ("adaptive_spill", dict(ring_slots=RING_SLOTS,
                            spill_buckets=SPILL_BUCKETS,
                            spill_slots=SPILL_SLOTS,
                            adaptive_k=True, k_max=K_MAX)),
)


def _hotset_batch(rng, device=None):
    """10RMW-style batch: each op hits the hot set w.p. HOT_FRAC, else
    the cold band; records >= HOT_N + COLD_N stay idle (the donor tail
    the adaptive policy reclaims capacity from)."""
    kind = rng.random((BATCH, OPS))
    recs = np.where(kind < HOT_FRAC,
                    rng.integers(0, HOT_N, (BATCH, OPS)),
                    rng.integers(HOT_N, HOT_N + COLD_N, (BATCH, OPS)))
    # distinct records per txn — the probe must iterate: one pass can
    # land a replacement on an earlier column
    while True:
        clean = True
        for col in range(1, OPS):
            dup = (recs[:, col:col + 1] == recs[:, :col]).any(axis=1)
            if dup.any():
                clean = False
                recs[dup, col] = (recs[dup, col] + 1) % (HOT_N + COLD_N)
        if clean:
            break
    return make_batch(recs, recs.copy(), np.zeros(BATCH, np.int32),
                      np.zeros((BATCH, 1), np.int32), device=device)


def _run_stream(eng: BohmEngine, batches) -> list:
    """One pass: updates + rolling pins + sweeps (the policy boundary);
    returns the pins still held at the end."""
    pins = []
    for i, batch in enumerate(batches):
        eng.run_batch(batch)
        if (i + 1) % PIN_EVERY == 0:
            pins.append(eng.begin_snapshot())
            while len(pins) > PINS_HELD:
                eng.release_snapshot(pins.pop(0))
            eng.gc_sweep()       # sweep + policy at pin boundaries, timed
    device_mod.fence(eng.store.base)
    return pins


def timed_passes(kw: dict, batches, n_passes: int, device):
    """Pass 0 warms up, then ``n_passes`` timed passes on fresh engines;
    returns (the last engine, its held pins, the pass times)."""
    wl = make_ycsb(payload_words=2, ops=OPS)
    times = []
    eng = pins = None
    for i in range(n_passes + 1):
        eng = BohmEngine(N_RECORDS, wl, device=device, **kw)
        t0 = time.perf_counter()
        pins = _run_stream(eng, batches)
        dt = time.perf_counter() - t0
        if i > 0:
            times.append(dt)
    return eng, pins, times


def found_rate(eng: BohmEngine, pins) -> float:
    """Found fraction of the hot + cold band's reads at every held pin."""
    probe_recs = np.arange(HOT_N + COLD_N)
    found = [eng.snapshot_read(probe_recs, pin)[1].cpu().numpy()
             for pin in pins]
    return float(np.concatenate(found).mean())


def bench_config(name: str, kw: dict, batches, n_passes: int,
                 device=None) -> dict:
    eng, pins, times = timed_passes(kw, batches, n_passes, device)
    n_txn = len(batches) * BATCH
    dt = min(times)
    spill = eng.spill_stats()
    k = eng.k_by_record().cpu().numpy()
    return {
        "config": name,
        "ring_slots": RING_SLOTS,
        "spill_capacity": spill["spill_capacity"],
        "found_rate": round(found_rate(eng, pins), 4),
        "txn_s": round(n_txn / dt),
        "us_per_txn": round(1e6 * dt / n_txn, 2),
        "spill_admitted": spill["spill_admitted"],
        "spill_dropped": spill["spill_dropped"],
        "spill_occupancy": spill["spill_occupancy"],
        "live_evictions": int(eng.overflow_by_record().sum()),
        "dead_evictions": eng.overflow_stats()["dead_overwrites"],
        "k_min_eff": int(k.min()),
        "k_max_eff": int(k.max()),
    }


def run(quick: bool = False, device=None) -> list:
    rng = np.random.default_rng(61)
    # quick trims TIMING passes only: found_rate needs the full stream
    n_passes = 1 if quick else 4
    batches = [_hotset_batch(rng, device) for _ in range(N_BATCHES)]
    rows = [bench_config(name, kw, batches, n_passes, device)
            for name, kw in CONFIGS]
    base = rows[0]
    for r in rows:
        r["found_vs_drop"] = round(r["found_rate"]
                                   / max(base["found_rate"], 1e-9), 3)
        r["txn_s_vs_drop"] = round(r["txn_s"] / base["txn_s"], 3)
    write_csv("spill", rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="1 timed pass a config instead of 4")
    args = ap.parse_args()
    if not needs_cuda("spill"):
        return 2
    run(args.quick)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
