"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and ``nvcc``; imports neither JAX nor
the JAX package. Phases, each of which must pass:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the CUDA kernels are compiled from ``src/repro_torch/kernels/
   csrc`` into ``build/repro_torch/`` (nvcc);
3. kernels: each kernel (``mvcc_resolve``, ``mvcc_resolve_masked``,
   ``mvcc_resolve_paged``) equals its plain PyTorch version on the card
   at its path's shapes and at an odd float32 shape, and is timed
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
   ring and spill arrays;
6. paged path: the same data scale through ``BohmEngine(1_000_000,
   make_ycsb(8), ring_slots=4, adaptive_k=True, k_max=16, paged=True,
   page_slots=2, pages_per_shard=2_000_000)`` (the storage settings of
   ``benchmarks/paged.py``): 9 batches, a pin every 2 batches (at most 3
   held) with a ``gc_sweep`` (and the adaptive-K policy) at each, then a
   read-only batch at the oldest pin, ``snapshot_read`` of records
   0-4095 at every pin, release, two sweeps. Found reads must equal the
   head store cloned at their pin; ``mvcc_resolve_paged`` and
   ``mvcc_resolve_masked`` must have launched and the policy must have
   granted slots. The dense twin (``adaptive_k=True, k_max=16,
   k_quantum=2``) must give byte-equal reads, capacities, pinned reads,
   overflow histogram and spill arrays while no page allocation failed
   (else: found paged reads equal the twin's), and a CPU replay of the
   paged engine must be byte-equal, page table included;
7. attention yardstick: ``scaled_dot_product_attention`` timed at the
   reference tests' decode and prefill shapes (fp32, bf16) beside the
   bound of the two attention kernels not ported yet.

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
from repro_torch.core.engine import BohmEngine, serial_oracle  # noqa: E402
from repro_torch.core.workloads import (gen_scan_batch,  # noqa: E402
                                        gen_ycsb_batch, make_ycsb)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mvcc_resolve as kmod  # noqa: E402
from repro_torch.obs import PhaseTracer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 peak
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
SOURCE = "src/repro_torch/kernels/csrc/mvcc_resolve.cu"
REPLACES = {"mvcc_resolve": "src/repro/kernels/mvcc_resolve.py:81",
            "mvcc_resolve_masked": "src/repro/kernels/mvcc_resolve.py:143",
            "mvcc_resolve_paged": "src/repro/kernels/mvcc_resolve.py:221"}
N_BATCHES, PIN_AFTER, N_SCANS, OPS = 9, 3, 1024, 10
PHASES = ("plan_phase", "exec_phase", "commit_phase")
# the paged path: YCSB_HIGH_10RMW's data scale with benchmarks/paged.py's
# storage settings, and its page-quantized dense twin
PAGED = dict(ring_slots=4, adaptive_k=True, k_max=16, paged=True,
             page_slots=2, pages_per_shard=1_000_000 * 4 // 2)
DENSE_TWIN = dict(ring_slots=4, adaptive_k=True, k_max=16, k_quantum=2)
PIN_EVERY, PINS_HELD, N_PROBE = 2, 3, 4096


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


def _paged_args(seed, P, S, max_pages, b, d, dtype):
    """A consistent page slab on the card (every begin distinct, so one
    slot is selected per read) and page-table rows shaped like the
    engine's: entry 0 mapped, entry j mapped with probability 2^-j.
    Below 5000 pages a row repeats no page."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    begin = torch.randperm(P * S * 2, **kw)[:P * S].reshape(P, S).to(
        torch.int32)
    end = begin + torch.randint(1, 30, (P, S), **kw, dtype=torch.int32)
    data = torch.randint(-1000, 1000, (P, S, d), **kw).to(dtype)
    if P < 5000:
        rows = torch.rand((b, P), **kw).argsort(dim=1)[:, :max_pages]
    else:
        rows = torch.randint(0, P, (b, max_pages), **kw)
    keep = torch.rand((b, max_pages), **kw) < 0.5 ** torch.arange(
        max_pages, device="cuda")
    # each read's ts lands near a version of its first page, so most
    # reads find one (versions live 1-29 ts)
    ts = begin[rows[:, 0], 0] + torch.randint(0, 10, (b,), **kw,
                                              dtype=torch.int32)
    rows = torch.where(keep, rows, -1).to(torch.int32).contiguous()
    return [rows, begin.contiguous(), end.contiguous(), data, ts]


def paged_need(args):
    """Bytes and operations the paged resolve needs on these inputs.
    Bytes: every page id, the begin/end of each DISTINCT mapped page
    (S x 8 bytes; reads of hot pages repeat), ts, the payload of each
    distinct selected slot, then vals and found. Operations: per mapped
    slot the interval test and the max, per selected payload word one
    add."""
    rows, begin, end, data, ts = args
    B, max_pages = rows.shape
    S, D = begin.shape[1], data.shape[2]
    mapped = rows >= 0
    n_pages = int(torch.unique(rows[mapped]).numel())
    safe = rows.clamp(min=0).long()
    t = ts[:, None, None]
    b = torch.where(mapped[..., None], begin[safe], 2 ** 31 - 1)
    vis = (b <= t) & (t < end[safe]) & mapped[..., None]
    best = torch.where(vis, b, kmod.NEG_INF).amax(dim=(1, 2))
    sel = vis & (b == best[:, None, None])
    slots = safe[..., None] * S + torch.arange(S, device=rows.device)
    n_sel = int(torch.unique(slots[sel]).numel())
    words = B * max_pages + 2 * S * n_pages + B + n_sel * D + B * D
    return 4 * words + B, 3 * S * int(mapped.sum()) + int(sel.sum()) * D


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


def _kernel_cases():
    """(name, shape, dtype, inputs, (bytes, operations)) of each kernel at
    its path's shape (int32), then at an odd float32 shape."""
    B0 = N_SCANS * OPS
    for name, masked, K in (("mvcc_resolve", False, 4),
                            ("mvcc_resolve_masked", True, 8)):
        for B, k, D, dtype in ((B0, K, 8, torch.int32),
                               (1000, 5, 33, torch.float32)):
            args = _windows(B + k, B, k, D, dtype, masked)
            yield name, [B, k, D], dtype, args, resolve_need(args, masked)
    # paged: [P, S, MaxP, B, D] — the paged path's slab, then an odd one
    for P, S, max_pages, B, D, dtype in (
            (PAGED["pages_per_shard"], 2, 8, B0, 8, torch.int32),
            (4099, 3, 5, 1000, 33, torch.float32)):
        args = _paged_args(P + B, P, S, max_pages, B, D, dtype)
        yield ("mvcc_resolve_paged", [P, S, max_pages, B, D], dtype, args,
               paged_need(args))


def kernel_phase():
    """Each kernel against its plain version on the same card inputs."""
    rows = {}
    for name, shape, dtype, args, (nbytes, ops) in _kernel_cases():
        kernel = getattr(kmod, name)
        plain = getattr(kmod, name + "_plain")
        vals, found = kernel(*args)
        p_vals, p_found = plain(*args)
        torch.cuda.synchronize()
        err = (vals.double() - p_vals.double()).abs().max().item()
        if err != 0 or not torch.equal(found, p_found):
            raise AssertionError(f"{name} {shape} {dtype}: kernel != plain "
                                 f"(max_abs_err {err})")
        ms = _device_ms(kernel, args)
        plain_ms = _device_ms(plain, args)
        host_ms = _host_ms(kernel, args)
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       ops / FP32_OPS_PER_S) * 1e3
        log(f"kernel {name} {shape} {str(dtype)[6:]}: equal to plain "
            f"(max_abs_err {err}); device: kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
            f"({nbytes} bytes); host per kernel call {host_ms * 1e3:.1f} us")
        if dtype == torch.int32:              # the path's own shape
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": None, "shape": shape, "bytes": nbytes,
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


# ---------------------------------------------------------------------------
# the paged path (adaptive K, page slab) and its dense twin
# ---------------------------------------------------------------------------
def drive_paged(device: str, cfg: dict, seed: int = 0):
    """YCSB_HIGH_10RMW's stream through an engine built with ``cfg``: 9
    batches, a pin every PIN_EVERY batches (at most PINS_HELD held) with a
    sweep at each, a read-only batch at the oldest pin, ``snapshot_read``
    of records 0..N_PROBE-1 at every pin, then release and two sweeps.
    Found reads are checked against the head store cloned at their pin.
    Returns what the twin and replay comparisons need."""
    cuda = device == "cuda"
    wc = YCSB_HIGH_10RMW
    eng = BohmEngine(wc.num_records, make_ycsb(payload_words=wc.payload_words),
                     device=device, tracer=PhaseTracer(enabled=True), **cfg)
    rng = np.random.default_rng(seed)
    out = {"reads": [], "k_sweeps": [], "batch_ms": [], "gc_ms": [],
           "pages_allocated": 0}
    pins = []                                   # (handle, head store at pin)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for i in range(N_BATCHES):
        batch = gen_ycsb_batch(rng, wc.batch_size, wc.num_records,
                               theta=wc.theta, mix=wc.mix, device=device)
        t0 = time.perf_counter()
        reads, metrics = eng.run_batch(batch)
        sync()
        out["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        out["pages_allocated"] += int(metrics.get("paged_pages_allocated",
                                                  0))
        out["reads"].append(reads.cpu().numpy())
        if (i + 1) % PIN_EVERY == 0:
            pins.append((eng.begin_snapshot(), eng.snapshot().clone()))
            while len(pins) > PINS_HELD:
                eng.release_snapshot(pins.pop(0)[0])
            t0 = time.perf_counter()
            eng.gc_sweep()
            out["gc_ms"].append((time.perf_counter() - t0) * 1e3)
            out["k_sweeps"].append(eng.k_by_record().cpu().numpy())
    out["spans_ms"] = {name: [x * 1e3 for x in ts] for name, ts in
                       eng.tracer.span_durations().items()}

    scan = gen_scan_batch(np.random.default_rng(seed + 1), N_SCANS,
                          wc.num_records, ops=OPS, theta=wc.theta,
                          device=device)
    oldest, oldest_base = pins[0]
    out["readonly_ms"] = []
    for _ in range(2):                          # first call, then warm
        t0 = time.perf_counter()
        vals, found, _ = eng.run_readonly_batch(scan, oldest)
        sync()
        out["readonly_ms"].append((time.perf_counter() - t0) * 1e3)
    expect = oldest_base[scan.read_set.long()]
    if not torch.equal(vals[found], expect[found]):
        raise AssertionError("paged read-only batch differs from the state "
                             "at its pin")
    out["ro"] = (vals.cpu().numpy(), found.cpu().numpy())
    probe = torch.arange(N_PROBE, dtype=torch.int32, device=device)
    out["pin_reads"] = []
    for pin, base in pins:
        s_vals, s_found = eng.snapshot_read(probe, pin)
        if not torch.equal(s_vals[s_found], base[:N_PROBE][s_found]):
            raise AssertionError(f"paged snapshot_read at {pin.ts} differs "
                                 "from the state at the pin")
        out["pin_reads"].append((s_vals.cpu().numpy(),
                                 s_found.cpu().numpy()))
    out["storage"] = eng.storage_stats()
    out["k_final"] = eng.k_by_record().cpu().numpy()
    out["overflow"] = eng.overflow_by_record().cpu().numpy()
    out["spill_stats"] = eng.spill_stats()
    out["counters"] = {k: eng.metrics.get(k, 0) for k in (
        "engine/k_slots_granted", "engine/k_slots_reclaimed")}
    out["store_pinned"] = store_to_numpy(eng.store)
    for pin, _ in pins:
        eng.release_snapshot(pin)
    out["gc"] = [eng.gc_sweep(), eng.gc_sweep()]
    out["store_final"] = store_to_numpy(eng.store)
    return out


def check_dense_twin(paged, dense):
    """The headline property at full size: the paged store answers like
    the dense ring with the same page-quantized capacity trajectory —
    while no page allocation failed. After a failed allocation the paged
    store may miss versions the twin keeps, but never answers stale: its
    found reads equal the twin's (and, checked in the drive, the state at
    their pin)."""
    failed = paged["storage"]["alloc_failed"]
    pairs = ([("ro", paged["ro"], dense["ro"])]
             + [(f"pin {i}", a, b) for i, (a, b) in enumerate(
                 zip(paged["pin_reads"], dense["pin_reads"]))])
    if failed:
        for key, (pv, pf), (dv, df) in pairs:
            if not (pf <= df).all() or not np.array_equal(pv[pf], dv[pf]):
                raise AssertionError(f"paged {key}: a found read differs "
                                     "from the dense twin")
        return f"{failed} page allocations failed: found reads equal"
    for i, (a, b) in enumerate(zip(paged["reads"], dense["reads"])):
        np.testing.assert_array_equal(a, b, err_msg=f"twin batch {i} reads")
    for i, (a, b) in enumerate(zip(paged["k_sweeps"], dense["k_sweeps"])):
        np.testing.assert_array_equal(a, b, err_msg=f"twin sweep {i} k_eff")
    for key, (pv, pf), (dv, df) in pairs:
        np.testing.assert_array_equal(pv, dv, err_msg=f"twin {key} vals")
        np.testing.assert_array_equal(pf, df, err_msg=f"twin {key} found")
    np.testing.assert_array_equal(paged["overflow"], dense["overflow"])
    for state in ("store_pinned", "store_final"):
        for name in paged[state]:
            if name.startswith("spill_") or name in ("base", "base_ts",
                                                     "k_eff"):
                np.testing.assert_array_equal(
                    paged[state][name], dense[state][name],
                    err_msg=f"twin {state}/{name}")
    return "byte-equal"


def check_replay(gpu, cpu):
    """The paged engine on the card against its CPU replay."""
    for i, (a, b) in enumerate(zip(gpu["reads"], cpu["reads"])):
        np.testing.assert_array_equal(a, b, err_msg=f"paged batch {i}")
    for i, (a, b) in enumerate(zip(gpu["k_sweeps"], cpu["k_sweeps"])):
        np.testing.assert_array_equal(a, b, err_msg=f"paged sweep {i}")
    for i, (a, b) in enumerate(zip([gpu["ro"]] + gpu["pin_reads"],
                                   [cpu["ro"]] + cpu["pin_reads"])):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"paged reads {i}")
    for state in ("store_pinned", "store_final"):
        assert set(gpu[state]) == set(cpu[state])
        for name in gpu[state]:
            np.testing.assert_array_equal(gpu[state][name], cpu[state][name],
                                          err_msg=f"paged {state}/{name}")
    np.testing.assert_array_equal(gpu["k_final"], cpu["k_final"])
    for key in ("storage", "spill_stats", "counters", "gc",
                "pages_allocated"):
        assert gpu[key] == cpu[key], (key, gpu[key], cpu[key])


# ---------------------------------------------------------------------------
# the attention kernels not ported yet: bound and library yardstick
# ---------------------------------------------------------------------------
def _sdpa(q, k, v, causal):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def attention_yardstick():
    """``scaled_dot_product_attention`` (GQA, one call) at the reference
    tests' shapes: decode B=2, KvH=5, G=3, Dh=128, T=1024
    (tests/test_kernels.py:52) and causal prefill B=1, S=512, KvH=4, G=2,
    Dh=128 (:112), fp32 and bf16, beside each kernel's bound: its inputs
    and output moved once, against 4 flops per (query, key, Dh) pair (QK
    and PV; causal prefill counts the S(S+1)/2 pairs on and below the
    diagonal) at the type's peak."""
    out = []
    for kind, (B, KvH, G, Dh, T) in (("decode_attention", (2, 5, 3, 128,
                                                           1024)),
                                     ("flash_attention_causal",
                                      (1, 4, 2, 128, 512))):
        H = KvH * G
        q_len = 1 if kind == "decode_attention" else T
        pairs = B * H * (T if q_len == 1 else T * (T + 1) // 2)
        for dtype, rate in ((torch.float32, FP32_OPS_PER_S),
                            (torch.bfloat16, BF16_OPS_PER_S)):
            g = torch.Generator(device="cuda").manual_seed(H + T)
            q = torch.randn((B, H, q_len, Dh), generator=g, device="cuda",
                            dtype=dtype)
            k = torch.randn((B, KvH, T, Dh), generator=g, device="cuda",
                            dtype=dtype)
            v = torch.randn((B, KvH, T, Dh), generator=g, device="cuda",
                            dtype=dtype)
            causal = q_len > 1
            o = _sdpa(q, k, v, causal)
            torch.cuda.synchronize()
            if not torch.isfinite(o.float()).all():
                raise AssertionError(f"sdpa {kind} {dtype}: not finite")
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            flops = 4 * pairs * Dh
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3
            ms = _device_ms(_sdpa, (q, k, v, causal))
            out.append({"kernel": kind, "dtype": str(dtype)[6:],
                        "shape": [B, KvH, G, Dh, T], "library_ms": ms,
                        "bound_ms": bound_ms,
                        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / rate else "operations",
                        "bytes": nbytes, "flops": flops})
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
    for name in ("mvcc_resolve", "mvcc_resolve_masked"):
        rows[name]["launches"] = launches[name]
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

    # -- the paged path, counted from zero ---------------------------------
    kmod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paged = drive_paged("cuda", PAGED)
    wall = time.perf_counter() - t0
    launches = dict(kmod.LAUNCHES)
    rows["mvcc_resolve_paged"]["launches"] = launches["mvcc_resolve_paged"]
    for name in ("mvcc_resolve_paged", "mvcc_resolve_masked"):
        if launches[name] <= 0:
            raise AssertionError(f"paged path launched {name} no time")
    if paged["counters"]["engine/k_slots_granted"] <= 0:
        raise AssertionError("the adaptive-K policy granted no slots")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st, sp = paged["storage"], paged["spans_ms"]
    steady = paged["batch_ms"][2:]
    ph = {k: round(statistics.median(sp[k][2:]), 3) for k in PHASES}
    log(f"paged path: launches {launches}; storage {st}; counters "
        f"{paged['counters']}; spill_stats {paged['spill_stats']}; gc "
        f"reclaimed {paged['gc']}")
    log(f"paged path: paged_pages_allocated {paged['pages_allocated']} "
        f"(summed over the batches); pages_mapped {st['pages_mapped']} / "
        f"pages_free {st['pages_free']}; alloc_failed {st['alloc_failed']}; "
        f"k_eff range [{paged['k_final'].min()}, {paged['k_final'].max()}]")
    log(f"paged path: batch ms {[round(x, 3) for x in paged['batch_ms']]}; "
        f"steady (batches 3-{N_BATCHES}) median batch "
        f"{statistics.median(steady):.3f} ms; median phase ms {ph}; gc_sweep"
        f" ms {[round(x, 3) for x in paged['gc_ms']]} of which reassign_k "
        f"ms {[round(x, 3) for x in sp['reassign_k']]}; readonly batch ms "
        f"(first, warm) {[round(x, 3) for x in paged['readonly_ms']]}; wall "
        f"{wall:.2f} s; peak device memory {peak:.3f} GiB")

    t0 = time.perf_counter()
    twin = drive_paged("cuda", DENSE_TWIN)
    verdict = check_dense_twin(paged, twin)
    log(f"dense twin (k_quantum=2): {verdict}; twin storage "
        f"{twin['storage']} ({time.perf_counter() - t0:.1f} s)")
    del twin
    t0 = time.perf_counter()
    check_replay(paged, drive_paged("cpu", PAGED))
    log(f"paged cpu replay: byte-equal reads, found, page table, slab, "
        f"spill, storage_stats and k_by_record "
        f"({time.perf_counter() - t0:.1f} s)")

    for row in attention_yardstick():
        log("attention yardstick: " + json.dumps(row))

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
