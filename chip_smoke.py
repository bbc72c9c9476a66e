"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and ``nvcc``; imports neither JAX nor
the JAX package. Phases, each of which must pass:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the CUDA kernels are compiled from ``src/repro_torch/kernels/
   csrc`` into ``build/repro_torch/`` (nvcc);
3. kernels: each kernel equals its plain PyTorch version on the card at
   the main path's shapes and at an odd float32 shape, and is timed
   against it with CUDA events (device time per call, median of 21
   rounds of 20 back-to-back calls);
4. main path: ``build(YCSB_HIGH_10RMW, device="cuda")`` — 1,000,000
   records, 8-word payloads, batches of 1024 zipfian (theta=0.9) 10-RMW
   transactions, spill tier on. Batch 1 must equal the serial oracle;
   a snapshot is pinned after batch 3 and, after 6 more batches, 1024
   read-only scans x 10 reads at the pin must return the pinned state
   wherever they find a version; then snapshot_read, gc_sweep,
   release_snapshot, gc_sweep. Both kernels' launch counters must have
   moved during this phase. An enabled ``PhaseTracer`` times each phase
   between two device synchronisations;
5. CPU replay: the same seeded stream through ``device="cpu"`` (the
   plain versions) must give byte-equal reads, found flags, head store,
   ring and spill arrays.

The line before the last is a JSON object with every kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.bohm_workloads import YCSB_HIGH_10RMW, build  # noqa: E402
from repro_torch.core.carry import store_to_numpy  # noqa: E402
from repro_torch.core.engine import serial_oracle  # noqa: E402
from repro_torch.core.workloads import gen_scan_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mvcc_resolve as kmod  # noqa: E402
from repro_torch.obs import PhaseTracer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 peak
SOURCE = "src/repro_torch/kernels/csrc/mvcc_resolve.cu"
REPLACES = {"mvcc_resolve": "src/repro/kernels/mvcc_resolve.py:81",
            "mvcc_resolve_masked": "src/repro/kernels/mvcc_resolve.py:143"}
N_BATCHES, PIN_AFTER, N_SCANS, OPS = 9, 3, 1024, 10
PHASES = ("plan_phase", "exec_phase", "commit_phase")


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------
def _windows(seed, b, k, d, dtype, masked):
    """Consistent version windows (sorted begins, end = next begin) on the
    card; masked windows get owner ids with free (-1) slots."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    begin = torch.randint(0, 100, (b, k), generator=g, device="cuda",
                          dtype=torch.int32).sort(dim=1).values
    end = torch.cat([begin[:, 1:], torch.full((b, 1), 2 ** 31 - 1,
                                              dtype=torch.int32,
                                              device="cuda")], 1)
    data = torch.randint(-1000, 1000, (b, k, d), generator=g,
                         device="cuda").to(dtype)
    ts = torch.randint(0, 120, (b,), generator=g, device="cuda",
                       dtype=torch.int32)
    if not masked:
        return [begin.contiguous(), end.contiguous(), data, ts]
    rec = torch.randint(-1, 3, (b, k), generator=g, device="cuda",
                        dtype=torch.int32)
    want = torch.randint(0, 3, (b,), generator=g, device="cuda",
                         dtype=torch.int32)
    return [begin.contiguous(), end.contiguous(), rec, want, data, ts]


def resolve_need(args, masked: bool):
    """Bytes and operations the resolve function needs on these inputs.
    Bytes (4-byte words, each input read once, each output written once):
    every slot's begin and end (+ rec, and want per read, when masked),
    ts, and the payload of the selected slots only — those at the largest
    visible begin, the only ones whose payload the result depends on —
    then vals and the one-byte found. Operations: per slot the interval
    test and the max (+ the owner compare), per selected payload word one
    add."""
    if masked:
        begin, end, rec, want, data, ts = args
    else:
        begin, end, data, ts = args
    B, K, D = data.shape
    t = ts[:, None]
    vis = (begin <= t) & (t < end)
    if masked:
        vis &= rec == want[:, None]
    best = torch.where(vis, begin, kmod.NEG_INF).max(dim=1).values
    n_sel = int((vis & (begin == best[:, None])).sum())
    words = B * K * (3 if masked else 2) + B * (2 if masked else 1) \
        + n_sel * D + B * D
    return 4 * words + B, B * K * (4 if masked else 3) + n_sel * D


def _device_ms(fn, args, rounds=21, reps=20, warmup=5):
    """Device time of one call: in each round a sleep kernel holds the
    stream while the host enqueues ``reps`` calls, which then run back to
    back between two CUDA events — so the host's per-call cost (checks,
    ctypes, allocation) is kept out. Median over ``rounds``."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)        # ~10 ms of SM clock cycles
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _host_ms(fn, args, reps=200):
    """Host time of one call (enqueue only, no synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    dt = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return dt


def kernel_phase():
    """Each kernel against its plain version on the same card inputs."""
    specs = {"mvcc_resolve": (kmod.mvcc_resolve, kmod.mvcc_resolve_plain,
                              False, 4),
             "mvcc_resolve_masked": (kmod.mvcc_resolve_masked,
                                     kmod.mvcc_resolve_masked_plain, True,
                                     8)}
    rows = {}
    for name, (kernel, plain, masked, K) in specs.items():
        for (B, k, D, dtype) in ((N_SCANS * OPS, K, 8, torch.int32),
                                 (1000, 5, 33, torch.float32)):
            args = _windows(B + k, B, k, D, dtype, masked)
            vals, found = kernel(*args)
            p_vals, p_found = plain(*args)
            torch.cuda.synchronize()
            err = (vals.double() - p_vals.double()).abs().max().item()
            if err != 0 or not torch.equal(found, p_found):
                raise AssertionError(f"{name} {B}x{k}x{D} {dtype}: kernel "
                                     f"!= plain (max_abs_err {err})")
            ms = _device_ms(kernel, args)
            plain_ms = _device_ms(plain, args)
            host_ms = _host_ms(kernel, args)
            nbytes, ops = resolve_need(args, masked)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / FP32_OPS_PER_S) * 1e3
            log(f"kernel {name} B={B} K={k} D={D} {str(dtype)[6:]}: equal "
                f"to plain (max_abs_err {err}); device: kernel {ms * 1e3:.2f} "
                f"us, plain {plain_ms * 1e3:.2f} us, bound "
                f"{bound_ms * 1e3:.3f} us ({nbytes} bytes); host per "
                f"kernel call {host_ms * 1e3:.1f} us")
            if dtype == torch.int32:          # the main path's shape
                rows[name] = {
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[name], "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": None, "shape": [B, k, D],
                    "host_ms": host_ms}
    return rows


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def drive(device: str, seed: int = 0, check_oracle: bool = False):
    """The main path on ``device``; returns what the replay compares."""
    cuda = device == "cuda"
    eng, gen = build(YCSB_HIGH_10RMW, seed=seed, device=device)
    eng.tracer = PhaseTracer(enabled=True)       # synchronised phase times
    out = {"reads": [], "waves": [], "batch_ms": []}
    for i in range(N_BATCHES):
        batch = gen()
        base0 = eng.snapshot().clone() if (check_oracle and i == 0) \
            else None
        t0 = time.perf_counter()
        reads, metrics = eng.run_batch(batch)
        waves = int(metrics["waves"])
        if cuda:
            torch.cuda.synchronize()
        out["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        out["waves"].append(waves)
        out["reads"].append(reads.cpu().numpy())
        if base0 is not None:
            o_final, o_reads = serial_oracle(base0, batch, eng.workload)
            if not (torch.equal(o_final, eng.snapshot())
                    and torch.equal(o_reads, reads)):
                raise AssertionError("batch 1 != serial_oracle")
            log("main path: batch 1 equals serial_oracle (head store "
                "and reads, byte-equal)")
        if i + 1 == PIN_AFTER:
            pin = eng.begin_snapshot()
            pinned_base = eng.snapshot().clone()
    out["phase_ms"] = {name: [x * 1e3 for x in ts] for name, ts in
                       eng.tracer.span_durations().items()
                       if name in PHASES}

    scan = gen_scan_batch(np.random.default_rng(seed + 1), N_SCANS,
                          eng.num_records, ops=OPS,
                          theta=YCSB_HIGH_10RMW.theta, device=device)
    out["readonly_ms"] = []
    for _ in range(2):                      # first call, then warm
        t0 = time.perf_counter()
        vals, found, rmetrics = eng.run_readonly_batch(scan, pin)
        if cuda:
            torch.cuda.synchronize()
        out["readonly_ms"].append((time.perf_counter() - t0) * 1e3)
    expect = pinned_base[scan.read_set.long()]
    if not torch.equal(vals[found], expect[found]):
        raise AssertionError("pinned read differs from the state at the pin")
    out["found_frac"] = float(rmetrics["found_frac"])
    out["ro_vals"], out["ro_found"] = vals.cpu().numpy(), found.cpu().numpy()
    hot = torch.arange(4096, dtype=torch.int32, device=device)
    s_vals, s_found = eng.snapshot_read(hot, pin)
    if not torch.equal(s_vals[s_found], pinned_base[:4096][s_found]):
        raise AssertionError("snapshot_read differs from the pinned state")
    out["snap_found"] = s_found.cpu().numpy()
    out["spill_stats"] = eng.spill_stats()
    out["store_pinned"] = store_to_numpy(eng.store)
    t0 = time.perf_counter()
    out["gc"] = [eng.gc_sweep()]
    out["gc_ms"] = (time.perf_counter() - t0) * 1e3
    eng.release_snapshot(pin)
    out["gc"].append(eng.gc_sweep())
    out["store_final"] = store_to_numpy(eng.store)
    out["txns"] = N_BATCHES * YCSB_HIGH_10RMW.batch_size
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available()"
              " is False); this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    path, nvcc_out = _build.build("mvcc_resolve")
    log(f"build: {path} in {time.perf_counter() - t0:.2f} s")
    for line in nvcc_out.strip().splitlines():
        log(f"  nvcc: {line}")

    rows = kernel_phase()

    kmod.reset_launches()                  # counts start at 0 for the path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gpu = drive("cuda", check_oracle=True)
    wall = time.perf_counter() - t0
    launches = dict(kmod.LAUNCHES)
    for name, row in rows.items():
        row["launches"] = launches[name]
        if launches[name] <= 0:
            raise AssertionError(f"main path launched {name} no time")
    steady = gpu["batch_ms"][2:]            # batches 1-2 warm up
    ph = {k: statistics.median(v[2:]) for k, v in gpu["phase_ms"].items()}
    log(f"main path: launches {launches}; found_frac {gpu['found_frac']:.6f}"
        f"; spill_stats {gpu['spill_stats']}; gc reclaimed {gpu['gc']}")
    log(f"main path: waves per batch {gpu['waves']}; batch ms "
        f"{[round(x, 3) for x in gpu['batch_ms']]}; steady (batches 3-"
        f"{N_BATCHES}) median batch {statistics.median(steady):.3f} ms = "
        f"{YCSB_HIGH_10RMW.batch_size / statistics.median(steady) * 1e3:.1f} "
        f"txn/s; median phase "
        f"ms { {k: round(v, 3) for k, v in ph.items()} }; readonly batch "
        f"ms (first, warm) {[round(x, 3) for x in gpu['readonly_ms']]}; "
        f"gc_sweep {gpu['gc_ms']:.3f} ms; "
        f"wall {wall:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

    t0 = time.perf_counter()
    cpu = drive("cpu")
    for i, (a, b) in enumerate(zip(gpu["reads"], cpu["reads"])):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i} reads")
    assert gpu["waves"] == cpu["waves"]
    for key in ("ro_vals", "ro_found", "snap_found"):
        np.testing.assert_array_equal(gpu[key], cpu[key], err_msg=key)
    for key in ("store_pinned", "store_final"):
        for name in gpu[key]:
            np.testing.assert_array_equal(gpu[key][name], cpu[key][name],
                                          err_msg=f"{key}/{name}")
    assert gpu["spill_stats"] == cpu["spill_stats"] and gpu["gc"] == cpu["gc"]
    log(f"cpu replay: byte-equal reads, found, head store, ring and spill "
        f"arrays ({time.perf_counter() - t0:.1f} s)")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
