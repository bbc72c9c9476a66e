"""Where a steady Bohm batch's time goes on the GPU (the port).

    python3 benchmarks_torch/breakdown.py [--batches 3] [--warmup 4]
                                          [--seed 0] [--paged]

Builds ``YCSB_HIGH_10RMW`` on the GPU (1,000,000 records, batches of 1024
zipfian theta=0.9 10-RMW transactions, spill tier on), warms it up, pins
a snapshot, then profiles ``--batches`` update batches and one read-only
batch (1024 scans x 10 reads at the pin) with ``torch.profiler``. The
engine's ``PhaseTracer(enabled=True, annotate=True)`` opens a
``record_function`` range per phase and synchronises the device at both
ends, so every kernel a phase launches runs inside its range.
``--paged`` runs the same stream on the paged store with
``chip_smoke.PAGED``'s storage settings (adaptive K, ``k_max=16``, 2M
pages of 2 slots; no sweep runs, so the policy keeps its start).

Prints per range (batch, plan_phase, exec_phase, commit_phase, readonly):
host wall ms, device kernel ms, kernel launches, host synchronisations
and the device busy share (kernel time over wall time), the unprofiled
batch wall time of the same configuration for comparison, and the
kernels with the most device time. Needs a GPU; exits non-zero without one or when the
profiler records no device activity.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import PAGED  # noqa: E402
from repro_torch.configs.bohm_workloads import YCSB_HIGH_10RMW, build  # noqa: E402
from repro_torch.core.engine import BohmEngine  # noqa: E402
from repro_torch.core.workloads import gen_scan_batch, make_ycsb  # noqa: E402
from repro_torch.obs import PhaseTracer  # noqa: E402

PHASES = ("plan_phase", "exec_phase", "commit_phase")
RANGES = ("batch", *PHASES, "readonly")


def range_table(prof, ranges, other_ranges=()):
    """Per profiled range (a ``record_function`` or tracer span name):
    calls, host wall ms, device kernel ms, kernel launches, host
    synchronisations and the busy share, each per call; prints them and
    the kernels with the most device time. ``other_ranges`` are annotation names to keep out of
    the kernel list. Returns None when the profiler saw no device
    activity."""
    events = list(prof.events())
    # device activity minus the GPU-side copies of our own ranges
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in (*ranges, *other_ranges)]
    if not kernels:
        print("breakdown: the profiler recorded no device activity; "
              "device time not measured", file=sys.stderr)
        return None
    # host waits on the device: CUDA runtime synchronise calls (a
    # blocking copy from pageable memory makes one, as does a span's fence)
    syncs = [e for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("cuda") and "Synchronize" in e.name]
    rows = {}
    for name in ranges:
        spans = sorted((e.time_range for e in events
                        if e.device_type == DeviceType.CPU
                        and e.name == name), key=lambda r: r.start)
        starts = [s.start for s in spans]

        def within(evs):
            # spans of one name do not overlap: test the last one that
            # starts at or before the event
            out = []
            for e in evs:
                i = bisect.bisect_right(starts, e.time_range.start) - 1
                if i >= 0 and e.time_range.start <= spans[i].end:
                    out.append(e)
            return out
        inside = within(kernels)
        host = sum(s.elapsed_us() for s in spans) / 1e3
        dev = sum(k.time_range.elapsed_us() for k in inside) / 1e3
        n = max(len(spans), 1)
        n_sync = len(within(syncs)) / n
        rows[name] = {"calls": len(spans), "wall_ms": host / n,
                      "device_ms": dev / n, "launches": len(inside) / n,
                      "syncs": n_sync, "busy": dev / host if host else None}
        print(f"{name:18s} calls {len(spans):3d}  wall {host / n:9.3f} ms  "
              f"device {dev / n:8.3f} ms  launches {len(inside) / n:8.1f}"
              f"  syncs {n_sync:6.1f}"
              f"  busy {100 * dev / host if host else 0:5.1f} %")
    per_kernel = collections.Counter()
    for k in kernels:
        per_kernel[k.name[:90]] += k.time_range.elapsed_us()
    total = sum(per_kernel.values())
    print("top kernels by device time over the profiled window:")
    for name, us in per_kernel.most_common(12):
        print(f"  {us / 1e3:8.3f} ms  {100 * us / total:5.1f} %  {name}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA device", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    cfg = YCSB_HIGH_10RMW
    eng, gen = build(cfg, seed=args.seed, device="cuda")
    if args.paged:                             # the same stream, paged
        eng = BohmEngine(cfg.num_records,
                         make_ycsb(payload_words=cfg.payload_words),
                         device="cuda", **PAGED)
    for _ in range(args.warmup):
        eng.run_batch(gen())
    pin = eng.begin_snapshot()
    wall = []                                  # unprofiled batches
    waves = []
    for _ in range(args.batches):
        t0 = time.perf_counter()
        _, m = eng.run_batch(gen())
        waves.append(int(m["waves"]))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    scan = gen_scan_batch(np.random.default_rng(args.seed + 1), 1024,
                          cfg.num_records, ops=10, theta=cfg.theta,
                          device="cuda")
    eng.run_readonly_batch(scan, pin)
    torch.cuda.synchronize()

    eng.tracer = PhaseTracer(enabled=True, annotate=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.batches):
            with record_function("batch"):
                _, m = eng.run_batch(gen())
                waves.append(int(m["waves"]))
                torch.cuda.synchronize()
        with record_function("readonly"):
            eng.run_readonly_batch(scan, pin)
            torch.cuda.synchronize()

    rows = range_table(prof, RANGES, ("read/resolve",))
    if rows is None:
        return 1
    med = statistics.median(wall)
    print(f"unprofiled batch wall ms {[round(x, 3) for x in wall]} "
          f"(median {med:.3f}); device busy share of an unprofiled batch "
          f"{100 * rows['batch']['device_ms'] / med:.1f} %; waves {waves}")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "unprofiled_batch_ms": med,
                      "ranges": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
