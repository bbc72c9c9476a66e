"""Host wall time of a warm snapshot read on the GPU (the port's read path).

    python3 benchmarks_torch/read_latency.py [--reps 50] [--seed 0]

Four read paths, each timed ``--reps`` times after three warm-up calls,
every call ended by ``torch.cuda.synchronize()``:

* ``dense``: ``build(YCSB_HIGH_10RMW)`` (1,000,000 records, one shard,
  spill on) after 6 update batches with a pin after the third;
  ``run_readonly_batch`` of 1024 zipfian (theta=0.9) scans x 10 reads at
  the pin, as ``chip_smoke.py``'s main path reads;
* ``two_shards``: the same stream and read batch on
  ``BohmEngine(n_shards=2)`` (logical shards on one device);
* ``paged``: the same stream and read batch on the paged store with
  ``chip_smoke.PAGED``'s storage settings (adaptive K, ``k_max=16``, 2M
  pages of 2 slots), read through ``mvcc_resolve_paged``;
* ``state_lookup``: the serving state store's engine as ``ServeEngine``
  builds it (1024 request ids, ``ring_slots=4``, ``state_shards=2``) and
  a ``lookup``-shaped read-only batch of all 1024 ids.

Prints per path the median, minimum and 90th percentile in ms, the card's
name and power limit, and one JSON line. Needs a GPU; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import PAGED  # noqa: E402
from repro_torch.configs.bohm_workloads import YCSB_HIGH_10RMW, build  # noqa: E402
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.txn import make_batch  # noqa: E402
from repro_torch.core.workloads import (gen_scan_batch,  # noqa: E402
                                        gen_ycsb_batch, make_ycsb)
from repro_torch.serving.engine import (STATE_WORDS,  # noqa: E402
                                        make_state_workload)


def timed(fn, reps):
    """Host ms of ``reps`` synchronised calls after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def pinned_engine(eng, seed):
    """Run YCSB_HIGH_10RMW's stream into ``eng``: 6 batches, a pin after
    the third. Returns the pin."""
    cfg = YCSB_HIGH_10RMW
    rng = np.random.default_rng(seed)
    for i in range(6):
        eng.run_batch(gen_ycsb_batch(rng, cfg.batch_size, cfg.num_records,
                                     theta=cfg.theta, mix=cfg.mix,
                                     device="cuda"))
        if i == 2:
            pin = eng.begin_snapshot()
    return pin


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("read_latency: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    cfg = YCSB_HIGH_10RMW
    scan = gen_scan_batch(np.random.default_rng(args.seed + 1), 1024,
                          cfg.num_records, ops=10, theta=cfg.theta,
                          device="cuda")
    times = {}
    eng, _ = build(cfg, seed=args.seed, device="cuda")
    pin = pinned_engine(eng, args.seed)
    times["dense"] = timed(lambda: eng.run_readonly_batch(scan, pin),
                           args.reps)
    del eng
    eng = BohmEngine(cfg.num_records,
                     make_ycsb(payload_words=cfg.payload_words), n_shards=2,
                     device="cuda")
    pin = pinned_engine(eng, args.seed)
    times["two_shards"] = timed(lambda: eng.run_readonly_batch(scan, pin),
                                args.reps)
    del eng
    eng = BohmEngine(cfg.num_records,
                     make_ycsb(payload_words=cfg.payload_words),
                     device="cuda", **PAGED)
    pin = pinned_engine(eng, args.seed)
    times["paged"] = timed(lambda: eng.run_readonly_batch(scan, pin),
                           args.reps)
    del eng
    state = BohmEngine(1024, make_state_workload(), ring_slots=4, n_shards=2,
                       device="cuda")
    rids = np.arange(1024)
    lookup = make_batch(rids[:, None], np.full((1024, 1), -1),
                        np.zeros(1024), np.zeros((1024, STATE_WORDS)),
                        device="cuda")
    times["state_lookup"] = timed(lambda: state.run_readonly_batch(lookup),
                                  args.reps)
    rows = {}
    for name, t in times.items():
        t = sorted(t)
        rows[name] = {"median_ms": statistics.median(t), "min_ms": t[0],
                      "p90_ms": t[int(0.9 * (len(t) - 1))], "reps": len(t)}
        print(f"{name:13s} warm read ms: median {rows[name]['median_ms']:.4f}"
              f"  min {t[0]:.4f}  p90 {rows[name]['p90_ms']:.4f}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi,
                      "paths": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
