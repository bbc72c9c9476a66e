"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and ``nvcc``; imports neither JAX nor
the JAX package. Phases, each of which must pass:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the CUDA sources ``src/repro_torch/kernels/csrc/*.cu`` are
   compiled into ``build/repro_torch/`` (one nvcc each, all started
   together);
3. kernels: each resolve kernel equals its plain PyTorch version bit
   for bit on the card at its path's shapes and at an odd float32
   shape, and is timed against it and its bound with CUDA events
   (device time per call, median of 21 rounds of 20 back-to-back
   calls): ``mvcc_resolve`` and ``mvcc_resolve_masked`` in both forms —
   pre-gathered windows, and in place over a consistent store shaped
   like the dense path's (a 1,000,000 x 4 ring, a 250,000 x 8 spill
   pool, 8-word payloads, 10,240 zipfian theta=0.9 row ids), the masked
   one with and without the ring's result as its prior — beside the old
   read path's call site (gathers + two windows launches + select) and
   the new one (two in-place launches), which must agree;
   ``mvcc_resolve_paged`` in both forms — the page table read in place
   (``rows=``), and its reads' table rows pre-gathered — on a
   1,000,000 x 8 table mapped as the engine maps it over the paged
   path's slab (2M pages of 2 slots) with the same 10,240 zipfian row
   ids, beside the old call site (table copy + windows launch) and the
   new one (one launch), which must agree, and at an odd float32 shape
   (39 candidates a read, 33 words); each
   attention kernel (``decode_attention``, ``flash_attention_causal``)
   agrees with its plain version in float32 (1e-5) and bfloat16 (2e-2
   decode, 3e-2 prefill) at the reference tests' shapes, the serving
   path's shapes, odd shapes and every shape phase 14 gives the kernels
   (deepseek-v2-lite's MLA prefill at Dh = 192, G = 5 and 6, seamless's
   4,096-frame cross-attention), gives the same bits on a second call,
   ignores a poisoned cache tail (decode), and is timed beside its plain
   version, its bound and one
   ``scaled_dot_product_attention(enable_gqa=True)`` call (the
   yardstick; the port never calls it); each case logs the kernel it
   launched (flash: ``wgmma`` for bf16 with Dh % 16 == 0, else
   ``cuda_cores``; decode: ``split_cluster``); and the backward of
   ``flash_attention_causal`` (``flash_attention_causal_bwd``: three
   kernels, row statistics, dk/dv, dq; the ``wgmma`` route on the tensor
   cores for bf16 with Dh % 16 == 0 and Dh <= 128, else ``cuda_cores``)
   against its plain version in
   float32 and bf16 at the reference tests' shapes, odd S, G = 1 and 3-7,
   Dh = 32-192 and the training shape (8, 2,048, 5, 3, 64): within 2e-5
   (float32) and 1e-2 (bf16) of the plain gradient's largest magnitude,
   the same bits on a second call, one launch of each kernel and of the
   expected route, timed
   beside the plain version, its bound (q, k, v, out, dout, dq, dk, dv
   bytes; 10 Dh flops a visible pair) and one SDPA backward;
4. main path: ``build(YCSB_HIGH_10RMW, device="cuda")`` — 1,000,000
   records, 8-word payloads, batches of 1024 zipfian (theta=0.9) 10-RMW
   transactions, spill tier on. Batch 1 must equal the serial oracle;
   a snapshot is pinned after batch 3 and, after 6 more batches, 1024
   read-only scans x 10 reads at the pin must return the pinned state
   wherever they find a version; then snapshot_read of records 0-4095
   and of the ids R, R+3 and 2R+1 past the store, which must read record
   R-1 as the reference's clamped gathers do; gc_sweep,
   release_snapshot, gc_sweep. Both kernels must have launched during
   this phase, in their in-place forms only. An enabled ``PhaseTracer`` times each phase
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
   0-4095 and of the ids past the store at every pin, release, two
   sweeps. Found reads must equal the head store cloned at their pin
   (record R-1 for ids past the store); ``mvcc_resolve_paged`` and
   ``mvcc_resolve_masked`` (in place only) must have launched and the
   policy must have
   granted slots. The dense twin (``adaptive_k=True, k_max=16,
   k_quantum=2``) must give byte-equal reads, capacities, pinned reads,
   overflow histogram and spill arrays while no page allocation failed
   (else: found paged reads equal the twin's), and a CPU replay of the
   paged engine must be byte-equal, page table included;
7. serving path: ``ServeEngine`` (the reference's defaults: 8 slots,
   pages of 16, 512 pages, 64 a sequence, bf16 KV, 1024 rids,
   ``state_shards=2``) over smollm-360m at its published widths and
   depth (32 layers, d_model 960, 15/5 heads, d_ff 2560, vocab 49152),
   bf16 weights from a seeded ``torch.Generator`` on the card. 16
   requests of 128-512-token prompts (page multiples), 32 new tokens
   each: 12 submitted and served, a progress view pinned, then 4 more
   (one repeating an earlier prompt, so the prefix cache hits and
   ``_logits_at`` runs). Every request must finish with 32 tokens and
   finite logits, every rid's ``lookup`` and ``progress_view`` must read
   done with 32 generated, the pinned view must be unchanged after the
   second wave, ``prefix_hits >= 1``, ``pages_recycled > 0``, and
   ``decode_attention``, ``flash_attention_causal``, ``mvcc_resolve``
   and ``mvcc_resolve_masked`` must all have launched (the last two in
   their in-place forms only): flash through its
   tensor-core kernel once a layer for every prefill and never through
   the CUDA-core one, decode once a layer for every decode step and
   prefix hit. Prints prefill
   ms per prompt, decode-step ms, generated tokens/s, the state-store
   batch's ms per step and peak memory;
8. serving replay: the same engine at full width with depth cut to 4
   layers, float32 weights and KV, 4 requests of 64-128 tokens and 8 new
   tokens, on the card and on the CPU (plain versions); on the card
   every prefill takes flash's CUDA-core (float32) kernel: equal tokens,
   last logits within 1e-3 of their largest magnitude, byte-equal
   lookups and state-store arrays;
9. service path: ``TxnService`` over ``build(YCSB_HIGH_10RMW,
   device="cuda")`` (the dense path's engine) with
   ``benchmarks/admission.py``'s ``mixed`` stream at the paper's scale:
   24 host-built batches of 1024 transactions of 10 distinct-record RMWs,
   keys uniform in a stripe (R/16 reserved, the rest cut into 8 stripes;
   a burst of 3 batches on one of 3 contended stripes every 8 batches,
   the rest round robin over the 5 cold stripes), a pin through
   ``svc.begin_snapshot()`` after batch 8 and, after the stream, 1024
   read-only scans x 10 reads at the pin. Three modes, each on a fresh
   engine: ``barriered`` (``pipelined=False``, window 1), ``fifo_w4``
   (``reorder=False``, window 4) and ``ooo`` (``max_inflight=4,
   admission_window=16, max_inflight_execs=4``) with an enabled
   ``FlightRecorder``. Every mode's per-ticket reads must equal
   ``run_batch`` in submission order on the card; its pinned read-only
   batch and, after a ``gc_sweep``, its head store and rings (and the
   spill pool where no epoch merged batches: a merged epoch hands the
   spill tier other evictees, in the reference too) must equal
   ``run_batch`` in its own ``dispatch_log`` order; ``ooo`` must merge
   and hop; only the in-place forms of rows 1-2 may launch; a CPU replay
   of ``ooo`` over the first 8 batches must be byte-equal (reads,
   schedule, counters, store). Prints per mode committed txn/s, epochs,
   the scheduler counters and the plan/exec/commit medians of a second,
   traced run (which must dispatch the same schedule); for ``ooo`` the
   flight breakdown's p50/p99 per phase and ``svc.health()``;
10. baselines: 2PL, OCC, SI and Hekaton on one ``YCSB_HIGH_10RMW`` batch
   (1,000,000 records, 1024 zipfian 10-RMW transactions) on the card
   (twice, the second timed) and on the CPU: base, reads and every stat
   byte-equal. Prints rounds, aborts, waits and committed txn/s beside
   Bohm's ``run_batch`` on the same batch (a fresh engine, the second of
   two timed);
11. arena: (a) ``run_gauntlet(default_scenarios())`` through all six
   adapters and ``si-schedule`` on the card: every row as expected, SI
   flagged exactly on the write-skew scenarios and ``si-schedule`` on
   write skew and the read-only anomaly, rows equal to a CPU run in
   every field; (b) the headline cell ``ycsb-10rmw-z0.9`` at the main
   path's scale (1,000,000 records, 8 payload words, 3 batches of 1024
   zipfian theta=0.9 10-RMW transactions) through ``run_cell(iters=1)``
   over the six protocols (``make_protocols``): every verdict
   serial-equivalent and exact, each protocol's certification stream
   (committed count, commit masks, read tags, final tags) equal to a CPU
   replay; prints the pivot, the rounds or waves of each row with the ms
   each took, and the headline (best Bohm variant against Hekaton and
   OCC; a miss warns, as in ``benchmarks/arena.py``); (c)
   ``scan-pinned-z0.9`` at 1,000,000 records (2 update batches, each
   followed by a pinned 1024 x 10 scan) through ``run_cell`` and a
   second stream whose scan reads and final store must equal the CPU's.
   Launches are counted from zero over (b) and (c): Bohm's scans read
   through rows 1-2 in their in-place forms only;
12. audited store: (a) ``BohmEngine(1_000_000, make_ycsb(8), auditor=
   LifecycleAuditor(capacity=1 << 20, per_record_cap=1 << 13))`` with the
   dense path's defaults over ``YCSB_HIGH_10RMW``'s stream: 9 batches, a
   pin after batch 3, ``gc_sweep`` after batches 6 and 9, then
   ``snapshot_read`` of the stream's 4096 most-written records at the
   pin, release and a sweep. An unaudited twin on the same seed must give
   byte-equal reads, pinned reads, store and launches, as many
   ``device.fence`` + ``torch.cuda.synchronize`` calls and as many
   synchronising operations inside ``run_batch`` (``torch.cuda.
   set_sync_debug_mode("warn")``). At the pin, every found=False must be
   explained by a drop event covering it and a sample of found reads must
   resolve to ``resident_*``; ``telescope()`` balanced and
   ``gc_report()["pin_stabbed_reclaims"] == 0`` at the pin and after the
   release, the delay histogram summing to ``reclaimed``. The default
   store keeps every pinned version here, so the same stream also runs
   with the spill tier cut to 128 buckets x 8 slots, where the pinned
   reads must miss and every miss must be explained; (b) the same on
   phase 6's paged engine (row 3 in place only); (c) ``TxnService`` in
   phase 9's ``ooo`` mode over 8 ``mixed`` batches on an audited engine
   with an enabled tracer, a ``FlightRecorder`` and a ``HealthMonitor``
   ticked after each wait: ``stitch_chrome_trace(tracer, flight,
   monitor=)`` must validate with spans, async lanes and counter tracks;
   (d) the first 4 batches of (a) and a sweep on the card and on the
   CPU: harvested events, state counts, GC report and telescope equal.
   Prints the events by state, the found=False reasons, harvest ms and
   the audited against the unaudited median batch ms.

13. paper suites (``benchmarks_torch/``): (a) ``snapshot``, ``spill``,
   ``paged``, ``pipeline``, ``serving`` and ``kernels`` at the
   reference's points (``--quick`` where a suite has it) on the CPU, then
   on the card: every row equal in every field that is not a wall time
   (``common.row_mismatches``; ``backend`` names the device), and
   ``kernels.py``'s two rows ``allclose``; (b) snapshot's two YCSB cells
   at 1,000,000 records (2-word payloads, theta 0.6, batches of 512,
   ring 8, one pass each) on the card and on the CPU, rows equal, and
   every found scan read of the pinned cell equal to the state at the
   pin; (c) ``microbench`` at its 1,000,000 records, card rows equal to
   the CPU's. Launches are counted from zero over the card runs of (a)
   without ``kernels.py`` (whose resolve row is the windows form by
   design), (b) and (c): rows 1-3 in their in-place forms only, and each
   of the five kernels launched. Prints every suite's rows beside the
   card's name and power limit, the twins as ``summarize.py`` renders
   them, and the headline metrics ``bench_history.py`` records (into a
   temporary directory).

14. models path: each of mamba2-370m, hymba-1.5b,
   seamless-m4t-large-v2, llava-next-mistral-7b, deepseek-v2-lite-16b
   (whole) and grok-1-314b (2 of 64 layers: the whole model needs 8
   cards) at full width through ``repro_torch.models``, one at a time,
   freed before the next. In bf16 from a seeded ``torch.Generator``:
   ``loss_fn`` and 3 timed ``prefill`` runs at B=2, S=512 (llava: 2,304
   patches + 256 tokens; seamless: 512 frames + 512 tokens), then
   ``init_cache(B=2, max_len=1024)`` and 32 timed ``decode_step``s, all
   finite; one more warm step under ``torch.cuda.set_sync_debug_mode``
   must make no synchronising operation. Launches counted from zero per
   configuration must be exactly one ``flash_attention_causal`` (wgmma
   route) per causal unwindowed self-attention layer and forward (MLA's
   at Dh = 192 included) and one ``decode_attention`` per GQA decode
   attention (self and cross) and step; exactly the hymba windowed
   layers' and seamless's encoder and cross-attention calls per forward
   run the blockwise torch code, and no decode call does. The latest
   launch of each kernel at each shape and dtype in the loss, in the
   warm step (over 33 keys; seamless's 4,096-frame encoder cache drawn
   from a seed, here and in the replay) and in the replay is held
   against its plain version on the same card tensors at phase 3's
   tolerances, and each bf16 shape must be one of phase 3's cases.
   Then a float32 replay (TF32
   off) at 2 layers (grok 1; the encoder cut alike): the last logits of
   a decode over a 64-token prompt (256, one SSD chunk, with SSM heads;
   text only; MoE at a capacity that drops nothing, since a prefill
   drops tokens past an expert's capacity and a one-token step never
   does) equal its ``prefill`` logits on the card (not enc-dec, whose
   prefill keeps no cache), and the card's loss, prefill logits
   and 8 decode steps equal a CPU run of the same weights within 1e-3
   of the largest magnitude (not grok: one float32 layer of its
   experts is 19.3 GB). Prints each configuration's median prefill and
   decode-step ms, peak memory, launches, blockwise calls and each held
   launch's error beside the card's name and power limit.

15. training path: ``Trainer`` over smollm-360m at full width and depth
   (32 layers) in bf16 from a seeded ``torch.Generator``, remat "full",
   AdamW, B=8, S=2,048 (SmolLM's pretraining context) on
   ``SyntheticTokenSource``, 20 steps: losses finite and the last below
   the first; every step launches exactly 64 ``flash_attention_causal``
   (wgmma route; the remat recompute included) and 32
   ``flash_attention_causal_bwd`` calls (three kernels each, the wgmma
   route), and no blockwise call; at step 10 a save through
   ``CheckpointManager`` and a restore into a fresh ``Trainer`` give
   bit-equal parameters and
   optimizer state, and the next step of both on one batch the same
   loss; the last step's latest forward and backward launch are held
   against the plain versions. Then a float32 gradient replay (TF32 off)
   of smollm, hymba, seamless, llava and deepseek-v2-lite (MLA at Dh =
   192, MoE at a capacity that drops nothing) at full width and 2 layers,
   B=1 and 32 tokens (hymba one SSD chunk, 256): the card's loss and
   gradients equal a CPU run of the same weights within 1e-3 of each
   leaf's largest magnitude, non-finite at the same places (hymba's SSD
   chunk overflows in the reference too: ROADMAP.md, known limits).
   Prints the median step ms, tokens/s, the share of the bf16 peak that
   6 N tokens / step time reaches, peak memory, launches and the held
   errors beside the card's name and power limit.

16. the roofline of phase 15's step: ``launch.dryrun.measure`` counts
   the same step (``launch.specs.make_train_step``: smollm-360m, B=8,
   S=2,048, bf16, remat "full") on fake tensors on the card and prints
   its compute, memory and fused-memory terms over the H100 model
   (``launch.mesh``), the useful ratio (6 N tokens / counted flops), the
   bound and phase 15's measured median step with bound / step beside
   it; the same counter (``launch.counting.dispatch_costs``) over one
   real step must give equal counts (flops, dot flops, bytes, fused
   bytes, kernel calls), and the fake run's peak per device must be
   within ``PEAK_TOL`` of ``torch.cuda.max_memory_allocated`` of that
   step. Then a (1, 1) ``DeviceMesh`` on the card over a real one-rank
   process group (``HashStore``): reduced smollm-360m's loss and
   gradient with parameters and batch as DTensors placed by
   ``parallel.sharding``, under the activation hints, give the plain
   tensors' bits and the same launches through the kernels' operators.
   Last, ``python -m repro_torch.launch.dryrun --mesh local`` for
   smollm-360m's three supported shapes (each cell ``ok``) and their
   roofline rows, beside the card's name and power limit.

The line before the last is a JSON object with every kernel's launches,
error and times (rows 1-3 in the in-place form the read path launches,
the windows form's and the two call sites' times beside them), then the
card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmarks_torch import bench_history, summarize  # noqa: E402
from benchmarks_torch import snapshot as snapshot_suite  # noqa: E402
from benchmarks_torch.arena import check_headline, markdown_pivot  # noqa: E402
from benchmarks_torch.common import (card_line, round_table,  # noqa: E402
                                     row_mismatches)
from repro_torch.arena import (PROTOCOL_NAMES, ArenaCell,  # noqa: E402
                               default_scenarios, make_protocols, run_cell,
                               run_gauntlet)
from repro_torch.arena.matrix import tag_replay  # noqa: E402
from repro_torch.configs.bohm_workloads import YCSB_HIGH_10RMW, build  # noqa: E402
from repro_torch.core.baselines import (run_2pl, run_hekaton,  # noqa: E402
                                        run_occ, run_si)
from repro_torch.core.carry import store_to_numpy  # noqa: E402
from repro_torch.core.engine import BohmEngine, serial_oracle  # noqa: E402
from repro_torch.core.txn import make_batch  # noqa: E402
from repro_torch.core.workloads import (gen_scan_batch,  # noqa: E402
                                        gen_ycsb_batch, make_ycsb)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mvcc_resolve as kmod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_OPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_OPS_PER_S  # noqa: E402
from repro_torch.models.layers import flatten, unflatten  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import transformer as models_tf  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.obs import (FlightRecorder, HealthMonitor,  # noqa: E402
                             LifecycleAuditor, MetricsRegistry, PhaseTracer,
                             stitch_chrome_trace, validate_chrome_trace)
from repro_torch.serving import STATE_DONE, ServeEngine  # noqa: E402
from repro_torch.serving import engine as serve_mod  # noqa: E402
from repro_torch.service import TxnService  # noqa: E402

SOURCE = "src/repro_torch/kernels/csrc/mvcc_resolve.cu"
SOURCES = ("mvcc_resolve", "decode_attention", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_wgmma")
# the backward is row 5's gradient: the reference has no Pallas backward
# (it differentiates its blockwise jnp attention, models/layers.py:114)
REPLACES = {"mvcc_resolve": "src/repro/kernels/mvcc_resolve.py:81",
            "mvcc_resolve_masked": "src/repro/kernels/mvcc_resolve.py:143",
            "mvcc_resolve_paged": "src/repro/kernels/mvcc_resolve.py:221",
            "decode_attention": "src/repro/kernels/decode_attention.py:63",
            "flash_attention_causal":
                "src/repro/kernels/flash_attention.py:77",
            "flash_attention_causal_bwd":
                "src/repro/kernels/flash_attention.py:77"}
ATT_SOURCE = {"decode_attention":
              "src/repro_torch/kernels/csrc/decode_attention.cu",
              "flash_attention_causal":
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "flash_attention_causal_bwd":
              "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu"}
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
def _dense_store(seed, R, K, NB, S, D, dtype):
    """A consistent ring [R, K] and spill pool [NB, S] on the card, shaped
    like the dense path's store: each ring row holds 1..K live versions
    with increasing begins from 100 on, each ending where the next
    begins (the newest open), in slots rotated by a random head (empty
    slots INF / INF); each pool bucket holds, in half its slots, a
    version of a record that hashes there (rec % NB == bucket) in [90 +
    6 s, 96 + 6 s) — disjoint per slot — and free slots (rec -1, INF)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    inf = 2 ** 31 - 1
    k = torch.arange(K, device="cuda")
    live = torch.randint(1, K + 1, (R, 1), **kw)
    b = 100 + torch.randint(0, 30, (R, 1), **kw) \
        + torch.randint(1, 20, (R, K), **kw).cumsum(1)
    e = torch.cat([b[:, 1:], torch.full_like(b[:, :1], inf)], 1)
    e = torch.where(k + 1 < live, e, inf)
    slot = (torch.randint(0, K, (R, 1), **kw) + k) % K
    empty = torch.full((R, K), inf, dtype=torch.int64, device="cuda")
    begin = empty.scatter(1, slot, torch.where(k < live, b, inf))
    end = empty.scatter(1, slot, torch.where(k < live, e, inf))
    payload = torch.randint(-1000, 1000, (R, K, D), **kw).to(dtype)
    s = torch.arange(S, device="cuda")
    rec = torch.arange(NB, device="cuda")[:, None] \
        + NB * torch.randint(0, max(R // NB, 1), (NB, S), **kw)
    free = torch.rand((NB, S), **kw) < 0.5
    pb = 90 + 6 * s + torch.randint(0, 3, (NB, S), **kw)
    pe = pb + torch.randint(1, 4, (NB, S), **kw)
    pool = [torch.where(free, inf, pb), torch.where(free, inf, pe),
            torch.where(free, -1, rec)]
    pp = torch.randint(-1000, 1000, (NB, S, D), **kw).to(dtype)
    ring = [x.to(torch.int32).contiguous() for x in (begin, end)]
    pool = [x.to(torch.int32).contiguous() for x in pool]
    return ring + [payload], pool + [pp]


def _dense_reads(seed, R, B):
    """B zipfian (theta=0.9) row ids, drawn as the dense path's read-only
    batch draws them, and ts in [90, 400): most reads find a ring version,
    some only a spilled one."""
    scan = gen_scan_batch(np.random.default_rng(seed), B // OPS, R, ops=OPS,
                          theta=YCSB_HIGH_10RMW.theta, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    ts = torch.randint(90, 400, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    return scan.read_set.reshape(-1).clamp(min=0).contiguous(), ts


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


def rows_need(begin, end, data, ts, rows):
    """Bytes and operations of the rows form: per read its row id and ts,
    the begin/end of each DISTINCT row in range (hot zipfian rows repeat,
    and L2 serves the repeats), the payload of each distinct selected
    slot, then vals and found."""
    B, (R, K), D = ts.numel(), begin.shape, data.shape[2]
    inside = (rows >= 0) & (rows < R)
    n_rows = int(torch.unique(rows[inside]).numel())
    safe = torch.where(inside, rows, 0).long()
    t = ts[:, None]
    vis = (begin[safe] <= t) & (t < end[safe]) & inside[:, None]
    best = torch.where(vis, begin[safe], kmod.NEG_INF).max(dim=1).values
    sel = vis & (begin[safe] == best[:, None])
    slots = safe[:, None] * K + torch.arange(K, device=rows.device)
    n_sel = int(torch.unique(slots[sel]).numel())
    words = 2 * B + 2 * K * n_rows + n_sel * D + B * D
    return 4 * words + B, 3 * K * int(inside.sum()) + int(sel.sum()) * D


def pool_need(begin, end, rec, want, data, ts, prior=None):
    """Bytes and operations of the pool (buckets) form: each read the
    prior did not find needs its want and ts, the begin/end/rec of each
    DISTINCT bucket such reads hit and the payload of each distinct
    selected slot; each read the prior found needs its prior found byte
    and D copied words; then vals and found."""
    B, (NB, S), D = ts.numel(), begin.shape, data.shape[2]
    scan = torch.ones_like(want, dtype=torch.bool) if prior is None \
        else ~prior[1]
    n_scan = int(scan.sum())
    bkt = (want.clamp(min=0) % NB).long()
    n_bkt = int(torch.unique(bkt[scan]).numel())
    t = ts[:, None]
    b = begin[bkt]
    vis = (b <= t) & (t < end[bkt]) & (rec[bkt] == want[:, None]) \
        & scan[:, None]
    best = torch.where(vis, b, kmod.NEG_INF).max(dim=1).values
    sel = vis & (b == best[:, None])
    slots = bkt[:, None] * S + torch.arange(S, device=want.device)
    n_sel = int(torch.unique(slots[sel]).numel())
    words = 2 * n_scan + 3 * S * n_bkt + n_sel * D + (B - n_scan) * D \
        + B * D
    nbytes = 4 * words + B + (0 if prior is None else B)
    return nbytes, 4 * S * n_scan + int(sel.sum()) * D


def old_call_site(rb, re, rp, pb, pe, prec, pp, rows, ts):
    """The read path before the in-place forms (PR 14's
    ``_resolve_two_level``, dense): gather the ring windows and the spill
    buckets, two windows-form launches, then the select."""
    r = rows.clamp(min=0).long()
    vals, found = kmod.mvcc_resolve(rb[r], re[r], rp[r], ts)
    bkt = (rows.clamp(min=0) % pb.shape[0]).long()
    s_vals, s_found = kmod.mvcc_resolve_masked(pb[bkt], pe[bkt], prec[bkt],
                                               rows, pp[bkt], ts)
    return torch.where(found[:, None], vals, s_vals), found | s_found


def new_call_site(rb, re, rp, pb, pe, prec, pp, rows, ts):
    """The read path's two in-place launches (``_resolve_two_level``)."""
    prior = kmod.mvcc_resolve(rb, re, rp, ts, rows=rows)
    return kmod.mvcc_resolve_masked(pb, pe, prec, rows, pp, ts,
                                    in_place=True, prior=prior)


def _paged_table_args(seed, R, P, S, max_pages, B, D, dtype):
    """A consistent page slab on the card (every begin distinct, so one
    slot is selected per read), a page table [R, MaxP] mapped as the
    engine maps it (entry 0 always, entry j with probability 2^-j) and
    ``_dense_reads``' B zipfian row ids, each read's ts near a version of
    its row's first page (versions live 1-29 ts). Returns the rows form's
    inputs (table, begin, end, data, ts) and the row ids."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    begin = torch.randperm(P * S * 2, **kw)[:P * S].reshape(P, S).to(
        torch.int32)
    end = begin + torch.randint(1, 30, (P, S), **kw, dtype=torch.int32)
    data = torch.randint(-1000, 1000, (P, S, D), **kw).to(dtype)
    table = torch.randint(0, P, (R, max_pages), **kw)
    keep = torch.rand((R, max_pages), **kw) < 0.5 ** torch.arange(
        max_pages, device="cuda")
    table = torch.where(keep, table, -1).to(torch.int32).contiguous()
    reads, _ = _dense_reads(seed, R, B)
    first = table[reads.long(), 0].long()
    ts = begin[first, 0] + torch.randint(0, 10, (B,), **kw,
                                         dtype=torch.int32)
    return [table, begin.contiguous(), end.contiguous(), data, ts], reads


def _paged_select(page_rows, begin, end, ts):
    """What a paged read batch selects: (distinct mapped pages, mapped
    entries, selected candidates, distinct selected slots)."""
    P, S = begin.shape
    mapped = (page_rows >= 0) & (page_rows < P)
    safe = torch.where(mapped, page_rows, 0).long()
    t = ts[:, None, None]
    b = torch.where(mapped[..., None], begin[safe], 2 ** 31 - 1)
    vis = (b <= t) & (t < end[safe]) & mapped[..., None]
    best = torch.where(vis, b, kmod.NEG_INF).amax(dim=(1, 2))
    sel = vis & (b == best[:, None, None])
    slots = safe[..., None] * S + torch.arange(S, device=begin.device)
    return (int(torch.unique(page_rows[mapped]).numel()),
            int(mapped.sum()), int(sel.sum()),
            int(torch.unique(slots[sel]).numel()))


def paged_need(page_rows, begin, end, data, ts):
    """Bytes and operations of the paged windows form on these inputs.
    Bytes: every page id, the begin/end of each DISTINCT mapped page
    (S x 8 bytes; reads of hot pages repeat), ts, the payload of each
    distinct selected slot, then vals and found. Operations: per mapped
    slot the interval test and the max, per selected payload word one
    add."""
    (B, max_pages), S, D = page_rows.shape, begin.shape[1], data.shape[2]
    n_pages, n_mapped, n_sel, n_slots = _paged_select(page_rows, begin, end,
                                                      ts)
    words = B * max_pages + 2 * S * n_pages + B + n_slots * D + B * D
    return 4 * words + B, 3 * S * n_mapped + n_sel * D


def table_need(table, begin, end, data, ts, rows):
    """Bytes and operations of the paged rows form: per read its row id
    and ts, the MaxP page ids of each DISTINCT row in range (hot zipfian
    rows repeat), then as the windows form: the begin/end of each
    distinct mapped page, the payload of each distinct selected slot,
    vals and found."""
    (R, max_pages), S, D = table.shape, begin.shape[1], data.shape[2]
    B = ts.numel()
    inside = (rows >= 0) & (rows < R)
    n_rows = int(torch.unique(rows[inside]).numel())
    page_rows = torch.where(inside[:, None],
                            table[torch.where(inside, rows, 0).long()], -1)
    n_pages, n_mapped, n_sel, n_slots = _paged_select(page_rows, begin, end,
                                                      ts)
    words = 2 * B + max_pages * n_rows + 2 * S * n_pages + n_slots * D \
        + B * D
    return 4 * words + B, 3 * S * n_mapped + n_sel * D


def old_paged_site(table, begin, end, data, ts, rows):
    """Row 3's call site before the rows form (``_resolve_two_level``,
    paged): copy the reads' table rows, then one windows-form launch."""
    return kmod.mvcc_resolve_paged(table[rows.long()], begin, end, data, ts)


def new_paged_site(table, begin, end, data, ts, rows):
    """Row 3's call site now: one launch over the table in place."""
    return kmod.mvcc_resolve_paged(table, begin, end, data, ts, rows=rows)


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


# rows 1-2 at the dense path's store (R, K, NB, S, D, B) and at an odd
# float32 shape
RESOLVE_SHAPES = {"path": (1_000_000, 4, 250_000, 8, 8, N_SCANS * OPS,
                           torch.int32),
                  "odd": (5003, 5, 1201, 5, 33, 1000, torch.float32)}


def _resolve_cases(label):
    """Rows 1-2 in both forms on one store and read batch: (name, form,
    inputs, keyword arguments, (bytes, operations)), then the call-site
    inputs. The windows forms get the windows the old read path gathered
    for these reads."""
    R, K, NB, S, D, B, dtype = RESOLVE_SHAPES[label]
    ring, pool = _dense_store(R + B, R, K, NB, S, D, dtype)
    rows, ts = _dense_reads(R + B, R, B)
    r, bkt = rows.long(), (rows % NB).long()
    win = [x[r] for x in ring] + [ts]
    win_m = [x[bkt] for x in pool[:3]] + [rows, pool[3][bkt], ts]
    in_ring, in_pool = ring + [ts], pool[:3] + [rows, pool[3], ts]
    prior = kmod.mvcc_resolve(*in_ring, rows=rows)
    cases = [
        ("mvcc_resolve", "windows", win, {}, resolve_need(win, False)),
        ("mvcc_resolve", "rows", in_ring, dict(rows=rows),
         rows_need(*in_ring, rows)),
        ("mvcc_resolve_masked", "windows", win_m, {},
         resolve_need(win_m, True)),
        ("mvcc_resolve_masked", "rows", in_pool, dict(in_place=True),
         pool_need(*in_pool)),
        ("mvcc_resolve_masked", "rows+prior", in_pool,
         dict(in_place=True, prior=prior), pool_need(*in_pool, prior))]
    return cases, ring + pool + [rows, ts]


# row 3 at the paged path's table and slab (R, P, S, MaxP, B, D) and at
# an odd float32 shape (MaxP * S = 39 candidates, D = 33)
TABLE_SHAPES = {"path": (1_000_000, PAGED["pages_per_shard"], 2, 8,
                         N_SCANS * OPS, 8, torch.int32),
                "odd": (1201, 4099, 3, 13, 1000, 33, torch.float32)}


def _time_against_plain(name, what, kernel, plain, args):
    """``kernel`` against ``plain`` on the same card inputs (bit for bit),
    then both timed; returns (max_abs_err, ms, plain_ms, host_ms)."""
    vals, found = kernel(*args)
    p_vals, p_found = plain(*args)
    torch.cuda.synchronize()
    err = (vals.double() - p_vals.double()).abs().max().item()
    if err != 0 or not torch.equal(found, p_found):
        raise AssertionError(f"{name} {what}: kernel != plain (max_abs_err "
                             f"{err})")
    return (err, _device_ms(kernel, args), _device_ms(plain, args),
            _host_ms(kernel, args))


def _row(name, err, ms, plain_ms, nbytes, ops, shape, host_ms):
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "shape": shape,
            "bytes": nbytes, "host_ms": host_ms}


def kernel_phase():
    """Each resolve kernel against its plain version on the same card
    inputs, timed beside it and its bound: rows 1-3 in both forms and
    their call sites. Returns the kernels line's rows: rows 1-3 in the
    form the read path launches (row 2 with its prior), with the windows
    form's and the call sites' numbers beside them."""
    rows = {}
    for label in RESOLVE_SHAPES:
        cases, site = _resolve_cases(label)
        dtype = str(RESOLVE_SHAPES[label][-1])[6:]
        timed = {}
        for name, form, args, kw, (nbytes, ops) in cases:
            kernel = functools.partial(getattr(kmod, name), **kw)
            plain = functools.partial(getattr(kmod, name + "_plain"), **kw)
            err, ms, plain_ms, host_ms = _time_against_plain(
                name, f"{form} {label}", kernel, plain, args)
            data = next(x for x in args if x.dim() == 3)
            shape = [*args[0].shape, data.shape[2],
                     args[-1].numel()]
            timed[name, form] = _row(name, err, ms, plain_ms, nbytes, ops,
                                     shape, host_ms)
            log(f"kernel {name} [{form}] {label} {shape} {dtype}: equal to "
                f"plain (max_abs_err {err}); device: kernel {ms * 1e3:.2f} "
                f"us, plain {plain_ms * 1e3:.2f} us, bound "
                f"{timed[name, form]['bound_ms'] * 1e3:.3f} us ({nbytes} "
                f"bytes); host per kernel call {host_ms * 1e3:.1f} us")
        old, new = old_call_site(*site), new_call_site(*site)
        if not all(torch.equal(a, b) for a, b in zip(old, new)):
            raise AssertionError(f"call sites differ ({label})")
        old_ms, new_ms = (_device_ms(fn, site)
                          for fn in (old_call_site, new_call_site))
        old_host, new_host = (_host_ms(fn, site)
                              for fn in (old_call_site, new_call_site))
        found = new[1].float().mean().item()
        log(f"resolve call site {label} {dtype} (found {found:.4f}): old "
            f"(gathers + 2 windows launches + select) device "
            f"{old_ms * 1e3:.2f} us, host {old_host * 1e3:.1f} us; new (2 "
            f"in-place launches) device {new_ms * 1e3:.2f} us, host "
            f"{new_host * 1e3:.1f} us; equal")
        if label != "path":
            continue
        for name, form in (("mvcc_resolve", "rows"),
                           ("mvcc_resolve_masked", "rows+prior")):
            win = timed[name, "windows"]
            rows[name] = dict(timed[name, form], form=form,
                              windows={k: win[k] for k in (
                                  "ms", "plain_ms", "bound_ms", "bytes",
                                  "shape")},
                              call_site_ms={"old": old_ms, "new": new_ms})
        rows["mvcc_resolve_masked"]["no_prior"] = {
            k: timed["mvcc_resolve_masked", "rows"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bytes")}
    for label, (R, P, S, max_pages, B, D, dtype) in TABLE_SHAPES.items():
        args, reads = _paged_table_args(R + B, R, P, S, max_pages, B, D,
                                        dtype)
        win = [args[0][reads.long()].contiguous()] + args[1:]
        timed = {}
        for form, a, kw, (nbytes, ops) in (
                ("windows", win, {}, paged_need(*win)),
                ("rows", args, dict(rows=reads), table_need(*args, reads))):
            name = "mvcc_resolve_paged"
            kernel = functools.partial(kmod.mvcc_resolve_paged, **kw)
            plain = functools.partial(kmod.mvcc_resolve_paged_plain, **kw)
            err, ms, plain_ms, host_ms = _time_against_plain(
                name, f"{form} {label}", kernel, plain, a)
            shape = [*a[0].shape, P, S, D, B]
            timed[form] = _row(name, err, ms, plain_ms, nbytes, ops, shape,
                               host_ms)
            log(f"kernel {name} [{form}] {label} {shape} "
                f"{str(dtype)[6:]}: equal to plain (max_abs_err {err}); "
                f"device: kernel {ms * 1e3:.2f} us, plain "
                f"{plain_ms * 1e3:.2f} us, bound "
                f"{timed[form]['bound_ms'] * 1e3:.3f} us ({nbytes} bytes); "
                f"host per kernel call {host_ms * 1e3:.1f} us")
        site = args + [reads]
        old, new = old_paged_site(*site), new_paged_site(*site)
        if not all(torch.equal(x, y) for x, y in zip(old, new)):
            raise AssertionError(f"paged call sites differ ({label})")
        old_ms, new_ms = (_device_ms(fn, site)
                          for fn in (old_paged_site, new_paged_site))
        old_host, new_host = (_host_ms(fn, site)
                              for fn in (old_paged_site, new_paged_site))
        log(f"paged call site {label} (found "
            f"{new[1].float().mean().item():.4f}): old (table copy + windows"
            f" launch) device {old_ms * 1e3:.2f} us, host "
            f"{old_host * 1e3:.1f} us; new (1 in-place launch) device "
            f"{new_ms * 1e3:.2f} us, host {new_host * 1e3:.1f} us; equal")
        if label == "path":
            win = timed["windows"]
            rows["mvcc_resolve_paged"] = dict(
                timed["rows"], form="rows",
                windows={k: win[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bytes", "shape", "host_ms")},
                call_site_ms={"old": old_ms, "new": new_ms},
                call_site_host_ms={"old": old_host, "new": new_host})
    return rows


def check_in_place(path, launches, names):
    """The path read only through the in-place forms of rows 1-3: no
    windows-form launch, and every kernel of ``names`` launched."""
    for name in ("mvcc_resolve", "mvcc_resolve_masked",
                 "mvcc_resolve_paged"):
        if launches[f"{name}/windows"] != 0 or \
                launches[f"{name}/rows"] != launches[name]:
            raise AssertionError(f"{path}: {name} launched a windows form "
                                 f"({launches})")
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{path} launched {name} no time")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def past_probe(n: int, R: int, device) -> torch.Tensor:
    """Records 0..n-1, then R-1 and three ids past the store: R, R+3 and
    2R+1, which read the last record as the reference's clamped gathers
    do."""
    return torch.cat([torch.arange(n), torch.tensor(
        [R - 1, R, R + 3, 2 * R + 1])]).to(device=device, dtype=torch.int32)


def check_past(vals, found, what):
    """``past_probe``'s last three reads equal its read of record R-1."""
    if not (torch.equal(vals[-3:], vals[-4:-3].expand(3, -1))
            and bool((found[-3:] == found[-4]).all())):
        raise AssertionError(f"{what}: reads past the store differ from "
                             "the last record's")


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
    hot = past_probe(4096, eng.num_records, device)
    s_vals, s_found = eng.snapshot_read(hot, pin)
    if not torch.equal(s_vals[s_found],
                       pinned_base[hot.clamp(max=eng.num_records - 1).long()]
                       [s_found]):
        raise AssertionError("snapshot_read differs from the pinned state")
    check_past(s_vals, s_found, "dense")
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
    probe = past_probe(N_PROBE, wc.num_records, device)
    out["pin_reads"] = []
    for pin, base in pins:
        s_vals, s_found = eng.snapshot_read(probe, pin)
        expect = base[probe.clamp(max=wc.num_records - 1).long()]
        if not torch.equal(s_vals[s_found], expect[s_found]):
            raise AssertionError(f"paged snapshot_read at {pin.ts} differs "
                                 "from the state at the pin")
        check_past(s_vals, s_found, f"paged at {pin.ts}")
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
# the attention kernels: against their plain versions, bound and yardstick
# ---------------------------------------------------------------------------
# decode (B, KvH, G, Dh, T) and prefill (B, S, KvH, G, Dh): the reference
# tests' sweeps (tests/test_kernels.py:52-55, :106-109), the serving
# path's shapes (8 slots and one prefix hit over MaxP * page = 1024
# positions; prompts of 128-512), an odd one (T, S not multiples of a
# tile or block) and every shape phase 14's bf16 runs give the kernels
# (``models``; model_bf16 fails on a shape missing here)
DECODE_CASES = [((1, 1, 1, 64, 64), "tests"), ((3, 2, 4, 64, 257), "tests"),
                ((2, 5, 3, 128, 1024), "tests"),
                ((4, 8, 1, 128, 96), "tests"),
                ((8, 5, 3, 64, 1024), "serving"),
                ((1, 5, 3, 64, 1024), "serving"),
                ((5, 3, 7, 40, 1000), "odd"),
                # hymba's global caches and its ring (kv_len = min(len, t))
                ((2, 5, 5, 64, 1024), "models"),
                # seamless's self-attention cache, its cross-attention
                # over 4,096 frames
                ((2, 16, 1, 64, 1024), "models"),
                ((2, 16, 1, 64, 4096), "models"),
                ((2, 8, 4, 128, 1024), "models"),        # llava
                ((2, 8, 6, 128, 1024), "models")]        # grok
FLASH_CASES = [((1, 128, 1, 1, 32), "tests"), ((2, 256, 2, 3, 64), "tests"),
               ((1, 512, 4, 2, 128), "tests"), ((2, 128, 2, 1, 64), "tests"),
               ((1, 128, 5, 3, 64), "serving"),
               ((1, 384, 5, 3, 64), "serving"),
               ((1, 512, 5, 3, 64), "serving"), ((1, 300, 5, 3, 64), "odd"),
               ((2, 77, 2, 4, 40), "odd"),
               ((2, 512, 5, 5, 64), "models"),           # hymba's globals
               ((2, 512, 16, 1, 64), "models"),          # seamless
               ((2, 2560, 8, 4, 128), "models"),         # llava
               # deepseek-v2-lite's MLA prefill: 16 heads of 128 + 64,
               # v padded to it (G = 1)
               ((2, 512, 16, 1, 192), "models"),
               ((2, 512, 8, 6, 128), "models")]          # grok
# the kernels line carries each kernel at its busiest serving shape, bf16
ROW_CASE = {"decode_attention": (8, 5, 3, 64, 1024),
            "flash_attention_causal": (1, 512, 5, 3, 64)}
ATT_TOL = {("decode_attention", torch.float32): 1e-5,
           ("decode_attention", torch.bfloat16): 2e-2,
           ("flash_attention_causal", torch.float32): 1e-5,
           ("flash_attention_causal", torch.bfloat16): 3e-2}
PEAK = {torch.float32: FP32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S}


def _sdpa(q, k, v, mask, causal):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)


def _attention_case(name, shape, label, dtype, device="cuda"):
    """Inputs on the card, the bytes and flops this run's data needs, and
    the SDPA arguments in its [B, H, L, Dh] layout (made contiguous
    outside the timed call). Decode counts only the K/V rows below each
    sequence's kv_len; prefill counts the causal (query, key <= query)
    pairs."""
    g_ = torch.Generator(device=device).manual_seed(sum(shape))
    kw = dict(generator=g_, device=device)

    def randn(*size):
        return torch.randn(size, **kw).to(dtype)

    esize = torch.tensor([], dtype=dtype).element_size()
    if name == "decode_attention":
        b, kvh, g, dh, t = shape
        q, k, v = randn(b, kvh, g, dh), randn(b, t, kvh, dh), \
            randn(b, t, kvh, dh)
        lo, hi = (129, 545) if label == "serving" else (1, t + 1)
        kl = torch.randint(lo, min(hi, t + 1), (b,), **kw,
                           dtype=torch.int32)
        keys = int(kl.sum())
        nbytes = (2 * q.numel() + 2 * keys * kvh * dh) * esize + 4 * b
        flops = 4 * keys * kvh * g * dh
        mask = (torch.arange(t, device=device)[None, :]
                < kl[:, None])[:, None, None, :]
        sdpa = (q.reshape(b, kvh * g, 1, dh), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), mask, False)
        return [q, k, v, kl], nbytes, flops, sdpa
    b, s, kvh, g, dh = shape
    q, k, v = randn(b, s, kvh, g, dh), randn(b, s, kvh, dh), \
        randn(b, s, kvh, dh)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
    flops = 4 * b * kvh * g * dh * s * (s + 1) // 2
    sdpa = (q.reshape(b, s, kvh * g, dh).transpose(1, 2).contiguous(),
            k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            None, True)
    return [q, k, v], nbytes, flops, sdpa


def _variant(name, before):
    """The kernel one call of ``name`` launched, from the launch counts
    before it: flash's route (``wgmma`` / ``cuda_cores``), decode's one
    kernel (``split_cluster``)."""
    moved = {k for k, n in ops.LAUNCHES.items() if n != before[k]}
    if name == "decode_attention":
        assert moved == {name}, moved
        return "split_cluster"
    routes = [k.split("/")[1] for k in moved if k.startswith(name + "/")]
    assert name in moved and len(routes) == 1, moved
    return routes[0]


def attention_phase(device="cuda"):
    """Each attention kernel against its plain version on the same card
    inputs at every case and dtype, timed beside the plain version, its
    bound and one SDPA call; the decode kernel also against a poisoned
    cache tail. Returns the kernels line's rows (serving shape, bf16)."""
    rows = {}
    cases = [("decode_attention", c) for c in DECODE_CASES] + \
        [("flash_attention_causal", c) for c in FLASH_CASES]
    for name, (shape, label) in cases:
        kernel = getattr(ops, name)
        plain = getattr(ops, name + "_plain")
        for dtype in (torch.float32, torch.bfloat16):
            args, nbytes, flops, sdpa = _attention_case(name, shape, label,
                                                        dtype, device)
            before = dict(ops.LAUNCHES)
            out = kernel(*args)
            variant = _variant(name, before)
            if not torch.equal(kernel(*args), out):
                raise AssertionError(f"{name} {shape} {dtype}: two calls on "
                                     "the same inputs differ")
            ref = plain(*args)
            err = (out.float() - ref.float()).abs().max().item()
            tol = ATT_TOL[(name, dtype)]
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            if name == "decode_attention":
                q, k, v, kl = args
                k2, v2 = k.clone(), v.clone()
                for i, n in enumerate(kl.tolist()):
                    k2[i, n:] = 1e9
                    v2[i, n:] = -1e9
                if not torch.equal(kernel(q, k2, v2, kl), out):
                    raise AssertionError(f"{name} {shape}: a poisoned tail "
                                         "beyond kv_len changed the output")
            lib = _sdpa(*sdpa)
            if not torch.isfinite(lib.float()).all():
                raise AssertionError(f"sdpa {name} {shape}: not finite")
            ms = _device_ms(kernel, args, rounds=11, reps=10)
            plain_ms = _device_ms(plain, args, rounds=11, reps=10)
            lib_ms = _device_ms(_sdpa, sdpa, rounds=11, reps=10)
            host_ms = _host_ms(kernel, args, reps=50)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK[dtype]
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            log(f"kernel {name} {label} {list(shape)} {str(dtype)[6:]} "
                f"[{variant}]: max_abs_err {err:.3g} (tol {tol}), repeat "
                f"bit-equal; device: kernel "
                f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, sdpa "
                f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
                f"({bound_by}: {nbytes} B, {flops} flop), "
                f"{100 * bound_ms / ms:.1f} % of bound; host per kernel "
                f"call {host_ms * 1e3:.1f} us")
            if tuple(shape) == ROW_CASE[name] and dtype == torch.bfloat16:
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": ATT_SOURCE[name], "replaces": REPLACES[name],
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "shape": list(shape), "dtype": "bfloat16",
                    "variant": variant,
                    "bytes": nbytes, "flops": flops, "host_ms": host_ms}
    return rows


# ---------------------------------------------------------------------------
# flash_attention_causal's backward (B, S, KvH, G, Dh): the reference
# tests' shapes, odd ones, G = 1-7, Dh = 32-192 and the training path's
# shape (phase 15: smollm-360m at B=8, S=2,048)
# ---------------------------------------------------------------------------
BWD_CASES = [((1, 128, 1, 1, 32), "tests"), ((2, 256, 2, 3, 64), "tests"),
             ((1, 512, 4, 2, 128), "tests"), ((2, 128, 2, 1, 64), "tests"),
             ((1, 300, 5, 3, 64), "odd"), ((2, 77, 2, 4, 40), "odd"),
             ((1, 257, 2, 7, 64), "odd"),
             ((2, 512, 5, 5, 64), "models"),           # hymba's globals
             ((2, 512, 8, 6, 128), "models"),          # grok, G = 6
             ((2, 512, 8, 4, 128), "models"),          # llava's heads
             ((2, 512, 16, 1, 192), "models"),         # MLA, Dh = 192
             ((8, 2048, 5, 3, 64), "training")]
TRAIN_SHAPE = (8, 2048, 5, 3, 64)
# relative to the plain backward's largest magnitude: float32 sums in
# another order (measured <= 5e-6 on an H100); bf16 adds one rounding of
# dq, dk, dv (measured <= 2.8e-3 on the CUDA cores) and, on the wgmma
# route, P and dS rounded to bf16 for the products (measured <= 6.9e-3)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def bwd_need(shape, dtype):
    """(bytes, flops) of the backward at ``shape``: q, k, v, out, dout
    read once and dq, dk, dv written once; 10 Dh flops a visible (query
    head, key) pair (S and dP recomputed, then dv, dk and dq: 2.5x the
    forward's 4 Dh)."""
    b, s, kvh, g, dh = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    q_n, k_n = b * s * kvh * g * dh, b * s * kvh * dh
    return ((4 * q_n + 4 * k_n) * esize,
            10 * b * kvh * g * dh * s * (s + 1) // 2)


def _bwd_inputs(shape, dtype, device="cuda"):
    """q, k, v, the forward kernel's output and a seeded dout."""
    b, s, kvh, g, dh = shape
    g_ = torch.Generator(device=device).manual_seed(sum(shape) + 1)

    def randn(*size):
        return torch.randn(size, generator=g_, device=device).to(dtype)

    q, k, v = randn(*shape), randn(b, s, kvh, dh), randn(b, s, kvh, dh)
    with torch.no_grad():
        out = ops.flash_attention_causal(q, k, v)
    return [q, k, v, out, randn(*shape)]


def _sdpa_bwd_args(q, k, v, dout):
    """SDPA's inputs in its [B, H, S, Dh] layout with a forward run, for
    timing its backward (``_sdpa_bwd``) alone."""
    b, s, kvh, g, dh = q.shape
    qs = q.reshape(b, s, kvh * g, dh).transpose(1, 2).contiguous()
    ks, vs = (x.transpose(1, 2).contiguous() for x in (k, v))
    leaves = [x.detach().requires_grad_(True) for x in (qs, ks, vs)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=True)
    do = dout.reshape(b, s, kvh * g, dh).transpose(1, 2).contiguous()
    return out, leaves, do


def _sdpa_bwd(out, leaves, do):
    return torch.autograd.grad(out, leaves, do, retain_graph=True)


def bwd_attention_phase(device="cuda"):
    """The backward kernel against the plain backward on the same card
    inputs at every BWD_CASES shape in float32 and bf16: within BWD_TOL of
    the plain result's largest magnitude, the same bits on a second call,
    one launch of each of its three kernels a call on the route that dtype
    and Dh pick (logged), timed beside the plain
    version, its bound and one SDPA backward. Returns the kernels line's
    row (the training shape, bf16)."""
    row = None
    for shape, label in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _bwd_inputs(shape, dtype, device)
            route = flash_mod.flash_bwd_route(*args)
            dh = shape[-1]
            expect = ("wgmma" if dtype == torch.bfloat16 and dh % 16 == 0
                      and dh <= flash_mod.BWD_WGMMA_MAX_DH else "cuda_cores")
            if route != expect:
                raise AssertionError(f"backward {shape} {dtype}: route "
                                     f"{route}, expected {expect}")
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention_causal_bwd(*args)
            moved = {k: ops.LAUNCHES[k] - before[k] for k in before
                     if ops.LAUNCHES[k] != before[k]}
            want = {"flash_attention_causal_bwd": 1,
                    f"flash_attention_causal_bwd/{route}": 1}
            want.update({f"flash_attention_causal_bwd/{k}": 1
                         for k in flash_mod.BWD_KERNELS})
            if moved != want:
                raise AssertionError(f"backward {shape}: launches {moved}")
            again = ops.flash_attention_causal_bwd(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"backward {shape} {dtype}: two calls "
                                     "on the same inputs differ")
            ref = ops.flash_attention_causal_bwd_plain(*args)
            errs = {}
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                scale = r.float().abs().max().clamp(min=1e-30)
                errs[name] = float((a.float() - r.float()).abs().max()
                                   / scale)
            tol = BWD_TOL[dtype]
            if max(errs.values()) > tol:
                raise AssertionError(f"backward {shape} {dtype}: relative "
                                     f"errors {errs} above {tol}")
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in zip(got, ref))
            big = shape == TRAIN_SHAPE
            timing = dict(rounds=5, reps=2) if big else \
                dict(rounds=11, reps=10)
            sdpa = _sdpa_bwd_args(args[0], args[1], args[2], args[4])
            ms = _device_ms(ops.flash_attention_causal_bwd, args, **timing)
            plain_ms = _device_ms(ops.flash_attention_causal_bwd_plain,
                                  args, **timing)
            lib_ms = _device_ms(_sdpa_bwd, sdpa, **timing)
            nbytes, flops = bwd_need(shape, dtype)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK[dtype]
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            log(f"kernel flash_attention_causal_bwd {label} {list(shape)} "
                f"{str(dtype)[6:]} ({route}): relative errors "
                f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol "
                f"{tol}), max_abs_err {err:.3g}, repeat bit-equal; device: "
                f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                f"sdpa backward {lib_ms * 1e3:.2f} us, bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} B, {flops} "
                f"flop), {100 * bound_ms / ms:.2f} % of bound")
            if big and dtype == torch.bfloat16:
                row = {"name": "flash_attention_causal_bwd", "route": "cuda",
                       "source": ATT_SOURCE["flash_attention_causal_bwd"],
                       "replaces": REPLACES["flash_attention_causal_bwd"],
                       "launches": 0, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms,
                       "shape": list(shape), "dtype": "bfloat16",
                       "kernel_route": route, "relative_err": errs,
                       "bytes": nbytes, "flops": flops}
            del args, got, again, ref, sdpa
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the serving path: ServeEngine over smollm-360m at full width
# ---------------------------------------------------------------------------
SERVE_ARCH, SERVE_NEW, WAVE1 = "smollm-360m", 32, 12
# 15 distinct prompts, page multiples from 128 to 512 tokens; rid 13
# repeats rid 0's prompt (a prefix hit). The prefix cache keeps every
# aligned prompt's pages (296 of the 512), so the decode pages fit.
SERVE_LENS = (128, 192, 256, 320, 384, 448, 512) * 2 + (256,)
REPLAY_LAYERS, REPLAY_LENS, REPLAY_NEW = 4, (64, 80, 96, 128), 8
STEP_FNS = ("_paged_decode_step", "_paged_prefill", "_logits_at")


def serving_prompts(vocab_size: int):
    """The serving path's 16 prompts, in submission order: SERVE_LENS
    drawn from seed 0, with rid 0's prompt repeated at rid WAVE1 + 1.
    ``benchmarks_torch/serve_breakdown.py`` serves the same traffic."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab_size, n).astype(np.int32)
               for n in SERVE_LENS]
    prompts.insert(WAVE1 + 1, prompts[0].copy())
    return prompts


class LogitsWatch:
    """Wraps the serving engine's three step functions while open: counts
    non-finite logits (of active slots, for decode) on the device, with
    no host sync, and keeps the last decode step's logits and active
    mask."""

    def __enter__(self):
        self.nonfinite, self.last = [], None
        self._saved = {n: getattr(serve_mod, n) for n in STEP_FNS}
        decode, prefill, logits_at = (self._saved[n] for n in STEP_FNS)

        def watched_decode(*args, **kw):
            logits = decode(*args, **kw)
            active = args[6]
            self.nonfinite.append(
                (~torch.isfinite(logits) & active[:, None]).sum())
            self.last = (logits, active)
            return logits

        def watched_prefill(*args, **kw):
            kv, logits = prefill(*args, **kw)
            self.nonfinite.append((~torch.isfinite(logits)).sum())
            return kv, logits

        def watched_logits_at(*args, **kw):
            logits = logits_at(*args, **kw)
            self.nonfinite.append((~torch.isfinite(logits)).sum())
            return logits

        for n, fn in zip(STEP_FNS, (watched_decode, watched_prefill,
                                    watched_logits_at)):
            setattr(serve_mod, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(serve_mod, n, fn)
        return False

    def count(self) -> int:
        return int(torch.stack(self.nonfinite).sum())


def _views_equal(a, b, what):
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=f"{what}: {key}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive_serving(cfg, device="cuda"):
    """The serving path (see the module doc) with ``cfg``'s model on
    ``device``. Returns the timings and counts to print."""
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    _sync(device)
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, tracer=PhaseTracer(enabled=True),
                      device=device)
    prompts = serving_prompts(cfg.vocab_size)
    n_req = len(prompts)
    with LogitsWatch() as watch:
        t0 = time.perf_counter()
        for rid in range(WAVE1):
            eng.submit(rid, prompts[rid], SERVE_NEW)
        eng.run()
        _sync(device)
        wave1_s = time.perf_counter() - t0
        pin = eng.begin_state_snapshot()
        view_pin = eng.progress_view(pin)
        t0 = time.perf_counter()
        for rid in range(WAVE1, n_req):
            eng.submit(rid, prompts[rid], SERVE_NEW)
        done = eng.run()
        _sync(device)
        wave2_s = time.perf_counter() - t0
    if watch.count():
        raise AssertionError(f"{watch.count()} non-finite logits")
    gens = {r.rid: r.generated for r in done}
    if sorted(gens) != list(range(n_req)) or any(
            len(g) != SERVE_NEW for g in gens.values()):
        raise AssertionError(f"requests did not all finish with {SERVE_NEW} "
                             f"tokens: { {k: len(g) for k, g in gens.items()} }")
    rids = np.arange(n_req)
    for view in (eng.progress_view(), eng.lookup(rids)):
        ok = ((view["status"][:n_req] == STATE_DONE)
              & (view["n_generated"][:n_req] == SERVE_NEW)
              & view["known"][:n_req])
        if not ok.all():
            raise AssertionError("a state lookup disagrees with the served "
                                 "requests")
        last = np.array([gens[r][-1] for r in rids])
        np.testing.assert_array_equal(view["last_token"][:n_req], last)
    pinned = eng.progress_view(pin)
    _views_equal(view_pin, pinned, "pinned progress view")
    if not (pinned["known"][:WAVE1].all()
            and not pinned["known"][WAVE1:].any()):
        raise AssertionError("the pinned view does not show wave 1 exactly")
    eng.release_state_snapshot(pin)
    stats = dict(eng.sched.stats)
    if stats["prefix_hits"] < 1 or stats["pages_recycled"] <= 0:
        raise AssertionError(f"scheduler stats {stats}")
    spans = eng.tracer.span_durations()
    return {"init_s": init_s, "wave_s": (wave1_s, wave2_s),
            "tokens": n_req * SERVE_NEW, "stats": stats,
            "health": eng.sched.health(), "steps": eng.steps,
            "prefill_lens": [len(p) for i, p in enumerate(prompts)
                             if i != WAVE1 + 1],
            "spans_ms": {k: [x * 1e3 for x in v] for k, v in spans.items()},
            "state_ts": eng.state.current_ts()}


def drive_replay(device, cfg, params):
    """The float32 replay's traffic on ``device``: 4 requests, 8 new
    tokens each; returns what the comparison needs."""
    eng = ServeEngine(cfg, params, kv_dtype=torch.float32, device=device)
    rng = np.random.default_rng(1)
    for rid, n in enumerate(REPLAY_LENS):
        eng.submit(rid, rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                   REPLAY_NEW)
    with LogitsWatch() as watch:
        done = eng.run()
    logits, active = watch.last
    return {"tokens": {r.rid: r.generated for r in done},
            "last": logits[active].float().cpu().numpy(),
            "nonfinite": watch.count(),
            "lookup": eng.lookup(np.arange(len(REPLAY_LENS) + 2)),
            "view": eng.progress_view(),
            "state": store_to_numpy(eng.state.store)}


def serving_replay(cfg, device="cuda"):
    """``cfg`` with depth cut to REPLAY_LAYERS, float32 (TF32 off): the
    run on ``device`` against the CPU's (plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cfg, num_layers=REPLAY_LAYERS, dtype="float32")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    params_cpu = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    before = dict(ops.LAUNCHES)
    gpu = drive_replay(device, cfg, params)
    routes = {r: ops.LAUNCHES[f"flash_attention_causal/{r}"]
              - before[f"flash_attention_causal/{r}"]
              for r in ("wgmma", "cuda_cores")}
    if routes["wgmma"] or routes["cuda_cores"] <= 0:
        raise AssertionError(f"float32 replay flash routes {routes}: "
                             "expected the CUDA-core kernel only")
    cpu = drive_replay("cpu", cfg, params_cpu)
    if gpu["tokens"] != cpu["tokens"]:
        raise AssertionError(f"replay tokens differ: {gpu['tokens']} vs "
                             f"{cpu['tokens']}")
    if gpu["nonfinite"] or cpu["nonfinite"]:
        raise AssertionError("replay: non-finite logits")
    rel = float(np.abs(gpu["last"] - cpu["last"]).max()
                / np.abs(cpu["last"]).max())
    if rel > 1e-3:
        raise AssertionError(f"replay last logits differ by {rel:.3g} of "
                             "their largest magnitude (limit 1e-3)")
    _views_equal(cpu["lookup"], gpu["lookup"], "replay lookup")
    _views_equal(cpu["view"], gpu["view"], "replay progress_view")
    assert set(gpu["state"]) == set(cpu["state"])
    for name in gpu["state"]:
        np.testing.assert_array_equal(gpu["state"][name], cpu["state"][name],
                                      err_msg=f"replay state {name}")
    return rel, gpu["tokens"], routes


# ---------------------------------------------------------------------------
# the service path: TxnService over the dense engine (phase 9)
# ---------------------------------------------------------------------------
# benchmarks/admission.py's ``mixed`` stream: R/16 reserved, the rest cut
# into 8 stripes; a burst of 3 back-to-back batches on one of the 3
# contended stripes every 8 batches, the others round robin over the 5
# cold stripes
MIX_STRIPES, MIX_BURST_STRIPES, MIX_HOT_BURST, MIX_HOT_PERIOD = 8, 3, 3, 8
SVC_BATCHES, SVC_PIN_AFTER, SVC_REPLAY = 24, 8, 8
OOO_KW = dict(max_inflight=4, admission_window=16, max_inflight_execs=4)
SVC_MODES = (
    ("barriered", dict(max_inflight=2, pipelined=False, admission_window=1)),
    ("fifo_w4", dict(max_inflight=2, admission_window=4, reorder=False)),
    ("ooo", OOO_KW))
FLIGHT_PHASES = ("queue", "formation", "exec", "commit_defer", "total")
SVC_COUNTERS = ("merged_batches", "hopped_batches", "overlapped_execs",
                "chain_depth_max")


def span_batch(rng, lo: int, hi: int, ops: int, t: int):
    """An RMW batch of ``t`` transactions over [lo, hi), ``ops`` distinct
    records each, uniform keys (``benchmarks/admission.py``'s
    ``_span_batch``), built on the host."""
    recs = rng.integers(lo, hi, size=(t, ops))
    for col in range(1, ops):
        dup = (recs[:, col:col + 1] == recs[:, :col]).any(axis=1)
        recs[dup, col] = lo + (recs[dup, col] - lo + col) % (hi - lo)
    return make_batch(recs, recs.copy(), np.zeros(t, np.int32),
                      np.zeros((t, 1), np.int32), device="cpu")


def mixed_stream(rng, n_records: int, n_batches: int, t: int, ops: int):
    """``benchmarks/admission.py``'s ``mixed`` stream at any scale."""
    hot = n_records // 16
    width = (n_records - hot) // MIX_STRIPES
    out, cold = [], 0
    for i in range(n_batches):
        if i % MIX_HOT_PERIOD < MIX_HOT_BURST:
            stripe = (i // MIX_HOT_PERIOD) % MIX_BURST_STRIPES
        else:
            stripe = MIX_BURST_STRIPES + cold % (MIX_STRIPES
                                                 - MIX_BURST_STRIPES)
            cold += 1
        lo = hot + stripe * width
        out.append(span_batch(rng, lo, lo + width, ops, t))
    return out


def drive_service(kw, batches, scan=None, device="cuda", flight=None,
                  traced=False):
    """One TxnService run over a fresh ``YCSB_HIGH_10RMW`` engine: submit
    every batch (a pin after ``SVC_PIN_AFTER`` when ``scan`` is given),
    wait every ticket, drain, then the read-only ``scan`` at the pin and a
    ``gc_sweep``. Returns the reads, the schedule, the counters, the
    pinned read, the store arrays and the timed wall."""
    eng = build(YCSB_HIGH_10RMW, device=device)[0]
    if traced:
        eng.tracer = PhaseTracer(enabled=True)
    svc = TxnService(eng, flight=flight, **kw)
    _sync(device)
    t0 = time.perf_counter()
    tickets, pin = [], None
    for i, b in enumerate(batches):
        tickets.append(svc.submit(b))
        if scan is not None and i + 1 == SVC_PIN_AFTER:
            pin = svc.begin_snapshot()
            pin_epochs = len(svc.dispatch_log)
    reads = [svc.wait(t).read_vals for t in tickets]
    svc.drain()
    wall = time.perf_counter() - t0
    out = {"wall": wall, "reads": [r.cpu().numpy() for r in reads],
           "log": [list(ep) for ep in svc.dispatch_log],
           "stats": dict(svc.stats),
           "spans_ms": {k: [x * 1e3 for x in v] for k, v in
                        eng.tracer.span_durations().items()}}
    if pin is not None:
        covered = sum(len(ep) for ep in svc.dispatch_log[:pin_epochs])
        if covered != SVC_PIN_AFTER:
            raise AssertionError(f"the pin covers {covered} batches")
        vals, found, _ = svc.run_readonly_batch(scan, pin)
        out["pinned"] = (pin.ts, vals.cpu().numpy(), found.cpu().numpy())
        out["health"] = svc.health()
    eng.gc_sweep()
    out["store"] = store_to_numpy(eng.store)
    return out


def drive_sequential(batches, order, scan, device="cuda"):
    """``run_batch`` on a fresh engine in ``order``, a pin after
    ``SVC_PIN_AFTER`` batches, the read-only ``scan`` at it, a sweep."""
    eng = build(YCSB_HIGH_10RMW, device=device)[0]
    reads = {}
    for k, i in enumerate(order):
        reads[i] = eng.run_batch(batches[i])[0].cpu().numpy()
        if k + 1 == SVC_PIN_AFTER:
            pin = eng.begin_snapshot()
    vals, found, _ = eng.run_readonly_batch(scan, pin)
    eng.gc_sweep()
    return {"reads": [reads[i] for i in range(len(batches))],
            "pinned": (pin.ts, vals.cpu().numpy(), found.cpu().numpy()),
            "store": store_to_numpy(eng.store)}


def _same_service(a, b, what, keys=("reads", "pinned", "store")):
    """Byte equality of two runs' reads, pinned read and store arrays."""
    if "reads" in keys:
        for i, (x, y) in enumerate(zip(a["reads"], b["reads"])):
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: batch {i}")
    if "pinned" in keys:
        assert a["pinned"][0] == b["pinned"][0], what
        for x, y in zip(a["pinned"][1:], b["pinned"][1:]):
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: pinned")
    if "store" in keys:
        assert set(a["store"]) == set(b["store"]), what
        # a merged epoch hands the spill tier other evictees than its
        # batches one by one (the reference does the same): its spill
        # arrays are held only by the pinned reads that fall through them
        merged = any(len(ep) > 1 for ep in a.get("log", ()))
        for name in a["store"]:
            if not (merged and name.startswith("spill_")):
                np.testing.assert_array_equal(
                    a["store"][name], b["store"][name],
                    err_msg=f"{what}: {name}")


def service_phase(device="cuda"):
    """Phase 9 (see the module doc): the three modes on ``device``, their
    sequential oracles there, and the CPU replay. Returns the runs, the
    launches of the three modes' runs and the replay's seconds."""
    wc = YCSB_HIGH_10RMW
    batches = mixed_stream(np.random.default_rng(47), wc.num_records,
                           SVC_BATCHES, wc.batch_size, OPS)
    scan = gen_scan_batch(np.random.default_rng(48), N_SCANS, wc.num_records,
                          ops=OPS, theta=wc.theta, device=device)
    kmod.reset_launches()                  # counts start at 0 for the path
    runs = {}
    for name, kw in SVC_MODES:
        flight = FlightRecorder(enabled=True) if name == "ooo" else None
        runs[name] = drive_service(kw, batches, scan, device, flight)
        runs[name]["flight"] = flight
    launches = dict(kmod.LAUNCHES)
    check_in_place("service path", launches, ("mvcc_resolve",
                                              "mvcc_resolve_masked"))
    for name, kw in SVC_MODES:             # phase medians, traced apart
        traced = drive_service(kw, batches, scan, device, traced=True)
        if traced["log"] != runs[name]["log"]:
            raise AssertionError(f"{name}: the traced run dispatched "
                                 "another schedule")
        runs[name]["spans_ms"] = traced["spans_ms"]
    submitted = drive_sequential(batches, range(SVC_BATCHES), scan, device)
    for name, _ in SVC_MODES:
        run = runs[name]
        _same_service(run, submitted, f"{name} vs submission order",
                      keys=("reads",))
        flat = [t for ep in run["log"] for t in ep]
        oracle = submitted if flat == list(range(SVC_BATCHES)) else \
            drive_sequential(batches, flat, scan, device)
        _same_service(run, oracle, f"{name} vs dispatch order",
                      keys=("pinned", "store"))
    st = runs["ooo"]["stats"]
    if st["merged_batches"] <= 0 or st["hopped_batches"] <= 0:
        raise AssertionError(f"ooo neither merged nor hopped: {st}")
    t0 = time.perf_counter()
    head = batches[:SVC_REPLAY]
    gpu = drive_service(OOO_KW, head, device=device)
    cpu = drive_service(OOO_KW, head, device="cpu")
    _same_service(gpu, cpu, "ooo cpu replay", keys=("reads", "store"))
    if (gpu["log"], gpu["stats"]) != (cpu["log"], cpu["stats"]):
        raise AssertionError("ooo cpu replay: another schedule")
    return runs, launches, time.perf_counter() - t0


def flight_breakdown(flight):
    """p50 / p99 ms of each lifecycle phase over the completed tickets."""
    bds = [f.breakdown() for f in flight.records()]
    return {k: [round(float(np.percentile([b[k] for b in bds], q)) * 1e3, 3)
                for q in (50, 99)] for k in FLIGHT_PHASES}


# ---------------------------------------------------------------------------
# the four baseline protocols at the paper's scale (phase 10)
# ---------------------------------------------------------------------------
BASELINES = (("2pl", run_2pl), ("occ", run_occ), ("si", run_si),
             ("hekaton", run_hekaton))


def baselines_phase(device="cuda"):
    """Phase 10: each protocol on one ``YCSB_HIGH_10RMW`` batch on
    ``device`` (twice: the second call timed) and on the CPU, byte-equal;
    Bohm's ``run_batch`` on the same batch beside them."""
    wc = YCSB_HIGH_10RMW
    R = wc.num_records
    batch = gen_ycsb_batch(np.random.default_rng(7), wc.batch_size, R,
                           theta=wc.theta, mix=wc.mix, device="cpu")
    wl = make_ycsb(payload_words=wc.payload_words)
    base = torch.zeros((R, wc.payload_words), dtype=torch.int32)
    gbase, gbatch = base.to(device), batch.to(device)
    rows = []
    for name, run in BASELINES:
        outs, ms = [], []
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            outs.append(run(gbase, gbatch, wl, R))
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        cpu = run(base, batch, wl, R)
        for out in outs:
            for i, what in ((0, "base"), (1, "reads")):
                if not torch.equal(out[i].cpu(), cpu[i]):
                    raise AssertionError(f"{name}: card {what} != cpu")
            if set(out[2]) != set(cpu[2]) or any(
                    out[2][k].dtype != v.dtype
                    or not torch.equal(out[2][k].cpu(), v)
                    for k, v in cpu[2].items()):
                raise AssertionError(f"{name}: card stats != cpu")
        stats = {k: int(v) for k, v in cpu[2].items() if v.dim() == 0}
        rows.append((name, stats, ms[1],
                     stats["commits"] / ms[1] * 1e3))
    bohm_ms = []
    for _ in range(2):                      # a fresh engine each, 2nd timed
        eng = build(wc, device=device)[0]
        _sync(device)
        t0 = time.perf_counter()
        _, metrics = eng.run_batch(gbatch)
        waves = int(metrics["waves"])
        _sync(device)
        bohm_ms.append((time.perf_counter() - t0) * 1e3)
        del eng
    rows.append(("bohm", {"waves": waves, "aborts": int(metrics["aborts"]),
                          "commits": wc.batch_size}, bohm_ms[1],
                 wc.batch_size / bohm_ms[1] * 1e3))
    return rows


# ---------------------------------------------------------------------------
# the protocol arena (phase 11)
# ---------------------------------------------------------------------------
ARENA_BATCHES, ARENA_SCAN_BATCHES = 3, 2


def gauntlet_phase(device="cuda"):
    """Phase 11a: the standing gauntlet through all six adapters and the
    SI schedule interpreter on the card, against its ground truth and a
    CPU run (every field)."""
    scenarios = default_scenarios(device=device)
    gpu = run_gauntlet(scenarios, device=device)
    bad = [(r["cell"], r["protocol"], r["verdict"]) for r in gpu
           if not r["as_expected"]]
    if bad:
        raise AssertionError(f"gauntlet: unexpected verdicts {bad}")
    flagged = {(r["cell"], r["protocol"]) for r in gpu
               if r["verdict"] != "serial-equivalent"}
    want = {(f"gauntlet:{sc.name}", p) for sc in scenarios
            for p, kinds in (("si", ("write-skew",)),
                             ("si-schedule", ("write-skew",
                                              "read-only-anomaly")))
            if sc.name.startswith(kinds)}
    if flagged != want:
        raise AssertionError(f"gauntlet flagged {sorted(flagged)}, "
                             f"expected {sorted(want)}")
    if gpu != run_gauntlet(default_scenarios(device="cpu"), device="cpu"):
        raise AssertionError("gauntlet: card rows != cpu rows")
    return gpu, flagged


def arena_cells(R: int, t: int, seed: int = 0):
    """The headline cell ``ycsb-10rmw-z0.9`` (``ARENA_BATCHES`` batches)
    and ``scan-pinned-z0.9`` (``ARENA_SCAN_BATCHES`` update batches, each
    followed by a pinned ``t`` x ``OPS`` scan), built on the host."""
    theta = YCSB_HIGH_10RMW.theta
    rng = np.random.default_rng(seed)
    head = ArenaCell("ycsb-10rmw-z0.9", "ycsb", R,
                     [gen_ycsb_batch(rng, t, R, theta=theta, mix="10rmw",
                                     device="cpu")
                      for _ in range(ARENA_BATCHES)],
                     theta=theta, mix="10rmw")
    scan = ArenaCell("scan-pinned-z0.9", "scan", R,
                     [gen_ycsb_batch(rng, t, R, theta=theta, mix="10rmw",
                                     device="cpu")
                      for _ in range(ARENA_SCAN_BATCHES)],
                     theta=theta, mix="10rmw",
                     scans=[gen_scan_batch(rng, t, R, ops=OPS, theta=theta,
                                           device="cpu")
                            for _ in range(ARENA_SCAN_BATCHES)])
    return head, scan


def cell_to(cell, device):
    return dataclasses.replace(
        cell, batches=[b.to(device) for b in cell.batches],
        scans=[b.to(device) for b in cell.scans])


def replay_stream(protos, cell):
    """Per protocol: the certification stream's committed count, commit
    masks, read tags and final tags, on the host."""
    out = {}
    for name, proto in protos.items():
        _, outs, final = tag_replay(proto, list(cell.batches))
        masks = [o.commit_mask.cpu().numpy() for o in outs]
        out[name] = {"committed": int(sum(m.sum() for m in masks)),
                     "masks": masks, "final": final,
                     "tags": [o.read_vals[:, :, 0].cpu().numpy()
                              for o in outs]}
    return out


def scan_stream(protos, cell):
    """Per protocol: submit each update batch, then the pinned scan after
    it; the scans' reads and the final store on the host."""
    out = {}
    for name, proto in protos.items():
        proto.reset()
        reads = []
        for batch, scan in zip(cell.batches, cell.scans):
            proto.submit(batch)
            reads.append(proto.run_scan(scan).cpu().numpy())
        out[name] = {"scans": reads, "final": proto.finish().cpu().numpy()}
    return out


def arena_phase(R: int = YCSB_HIGH_10RMW.num_records,
                t: int = YCSB_HIGH_10RMW.batch_size, device="cuda"):
    """Phase 11b-c (see the module doc) on ``device``, against the CPU.
    Returns the rows of both cells, the launches of the card's arena path
    and the CPU replay's seconds."""
    head, scan = arena_cells(R, t)
    wl = make_ycsb(payload_words=YCSB_HIGH_10RMW.payload_words, ops=OPS)
    kmod.reset_launches()                  # counts start at 0 for the path
    registry = MetricsRegistry()
    protos = make_protocols(R, wl, registry, device=device)
    g_head, g_scan = cell_to(head, device), cell_to(scan, device)
    rows = run_cell(g_head, protos, iters=1, registry=registry)
    for r in rows:
        if (r["verdict"], r["exact"]) != ("serial-equivalent", True):
            raise AssertionError(f"{r['protocol']}: {r['verdict']}, exact "
                                 f"{r['exact']}")
    gpu_replay = replay_stream(protos, g_head)
    rows += run_cell(g_scan, protos, iters=1, registry=registry)
    gpu_scans = scan_stream(protos, g_scan)
    launches = dict(kmod.LAUNCHES)
    check_in_place("arena path", launches, ("mvcc_resolve",
                                            "mvcc_resolve_masked"))
    del protos
    t0 = time.perf_counter()
    cpu = make_protocols(R, wl, device="cpu")
    cpu_replay = replay_stream(cpu, head)
    for name in gpu_replay:
        np.testing.assert_equal(gpu_replay[name], cpu_replay[name],
                                err_msg=f"arena {name}")
        row = next(r for r in rows if r["protocol"] == name)
        if row["committed"] != gpu_replay[name]["committed"]:
            raise AssertionError(f"{name}: row committed {row['committed']}"
                                 f" != replay {gpu_replay[name]['committed']}")
    np.testing.assert_equal(gpu_scans, scan_stream(cpu, scan),
                            err_msg="arena scans")
    return rows, launches, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the audited store (phase 12)
# ---------------------------------------------------------------------------
AUDIT_KW = dict(capacity=1 << 20, per_record_cap=1 << 13)
AUDIT_SWEEPS, AUDIT_TOP, AUDIT_SAMPLE = (6, 9), 4096, 64
# the spill tier cut so that one held pin saturates it (the default pool
# of R/4 buckets x 8 slots never drops a pinned version on this stream)
AUDIT_SATURATE = dict(spill_buckets=128)
SVC_AUDIT_BATCHES = 8


class Joins:
    """Counts the host joins a run makes: ``repro_torch.device.fence`` and
    ``torch.cuda.synchronize`` calls (patched while the block runs), and
    with ``sync_debug`` the synchronising CUDA operations that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports inside ``hot()``
    blocks."""

    def __init__(self):
        self.calls = 0
        self.hot_syncs = 0
        self.hot_sites = collections.Counter()
        if torch.cuda.is_available():
            # the mode's first switch in a process may warn once by itself;
            # take that here, outside any count
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode("warn")
                torch.cuda.set_sync_debug_mode(0)

    def __enter__(self):
        self._fence, self._sync = device_mod.fence, torch.cuda.synchronize

        def fence(x):
            self.calls += 1
            return self._fence(x)

        def sync(*a, **k):
            self.calls += 1
            return self._sync(*a, **k)

        device_mod.fence, torch.cuda.synchronize = fence, sync
        return self

    def __exit__(self, *exc):
        device_mod.fence, torch.cuda.synchronize = self._fence, self._sync
        return False

    def hot(self, fn, *args):
        """``fn(*args)`` with the CUDA sync-debug warnings counted."""
        if not torch.cuda.is_available():
            return fn(*args)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        for w in seen:
            if "called a synchronizing CUDA operation" in str(w.message):
                self.hot_syncs += 1
                self.hot_sites[f"{Path(w.filename).name}:{w.lineno}"] += 1
        return out


def audit_stream(cfg: dict, audited: bool, device: str, R: int,
                 t: int, n_batches: int = N_BATCHES, seed: int = 0,
                 sweeps=AUDIT_SWEEPS, release: bool = True,
                 need_misses: bool = False, count_syncs: bool = True,
                 traced: bool = False):
    """YCSB_HIGH_10RMW's stream (zipfian theta=0.9 10-RMW batches of ``t``
    over ``R`` records, 8 words) through ``BohmEngine(R, make_ycsb(8),
    **cfg)``, with a ``LifecycleAuditor(**AUDIT_KW)`` when ``audited``: a
    pin after batch ``PIN_AFTER``, ``gc_sweep`` after each batch in
    ``sweeps``, then ``snapshot_read`` of the stream's ``AUDIT_TOP``
    most-written records at the pin, explained by the auditor while the
    pin holds (``explain_at_pin``); with ``release`` the pin is released
    and swept. ``count_syncs`` counts the synchronising operations inside
    ``run_batch`` (which slows it: time with it off); ``traced`` times the
    phases with an enabled tracer. Returns the engine, what the checks
    compare and the timings."""
    wc = YCSB_HIGH_10RMW
    aud = LifecycleAuditor(**AUDIT_KW) if audited else None
    eng = BohmEngine(R, make_ycsb(payload_words=wc.payload_words),
                     auditor=aud, device=device,
                     tracer=PhaseTracer(enabled=traced), **cfg)
    harvest = {"s": 0.0, "n": 0, "events": 0}
    if aud is not None:
        real = aud.harvest

        def timed_harvest():
            t0 = time.perf_counter()
            n = real()
            if n:
                harvest["s"] += time.perf_counter() - t0
                harvest["n"] += 1
                harvest["events"] += n
            return n
        aud.harvest = timed_harvest
    rng = np.random.default_rng(seed)
    out = {"reads": [], "batch_ms": [], "harvest": harvest}
    written = np.zeros(R, np.int64)
    with Joins() as joins:
        for i in range(n_batches):
            batch = gen_ycsb_batch(rng, t, R, theta=wc.theta, mix=wc.mix,
                                   device=device)
            w = batch.write_set.reshape(-1).cpu().numpy()
            np.add.at(written, w[w >= 0], 1)
            t0 = time.perf_counter()
            reads, _ = (joins.hot(eng.run_batch, batch) if count_syncs
                        else eng.run_batch(batch))
            _sync(device)
            out["batch_ms"].append((time.perf_counter() - t0) * 1e3)
            out["reads"].append(reads.cpu().numpy())
            if i + 1 == PIN_AFTER:
                pin = eng.begin_snapshot()
            if i + 1 in sweeps:
                eng.gc_sweep()
        top = np.argsort(-written, kind="stable")[:AUDIT_TOP]
        vals, found = eng.snapshot_read(torch.from_numpy(top).to(device),
                                        pin)
        out["pinned"] = (vals.cpu().numpy(), found.cpu().numpy())
        out["pinned_store"] = store_to_numpy(eng.store)
        if aud is not None:            # the account while the pin holds
            out["reasons"] = explain_at_pin(aud, pin.ts, top,
                                            out["pinned"][1], need_misses)
            out["at_pin"] = (aud.telescope(), aud.gc_report())
        if release:
            eng.release_snapshot(pin)
            eng.gc_sweep()
        eng.snapshot()
    out["phase_ms"] = {k: [x * 1e3 for x in v] for k, v in
                       eng.tracer.span_durations().items() if k in PHASES}
    out.update(eng=eng, pin=pin, top=top, joins=joins.calls,
               hot_syncs=joins.hot_syncs, hot_sites=joins.hot_sites,
               store=store_to_numpy(eng.store))
    return out


def explain_at_pin(aud, ts: int, top, found, need_misses: bool):
    """The auditor's account of the pinned reads, while the pin holds:
    every found=False explained by a drop event covering the pin (with
    ``need_misses`` there must be some), a sample of found reads resolved
    to a resident version. Returns the reasons counted."""
    misses = np.nonzero(~found)[0]
    if need_misses and misses.size == 0:
        raise AssertionError("the stream never saturated the store")
    reasons = {}
    for i in misses:
        exp = aud.explain_read(int(top[i]), ts)
        ev = exp["event"]
        if exp["found"] or ev is None or not ev.covers(ts):
            raise AssertionError(f"record {top[i]} missed at the pin "
                                 f"without a covering drop event: {exp}")
        reasons[exp["reason"]] = reasons.get(exp["reason"], 0) + 1
    hits = np.nonzero(found)[0]
    sample = hits[np.linspace(0, hits.size - 1, min(AUDIT_SAMPLE, hits.size)
                              ).astype(int)] if hits.size else hits
    for i in sample:
        exp = aud.explain_read(int(top[i]), ts)
        if not (exp["found"] and exp["reason"].startswith("resident_")):
            raise AssertionError(f"found read of {top[i]} not resident: "
                                 f"{exp}")
        reasons[exp["reason"]] = reasons.get(exp["reason"], 0) + 1
    return reasons


def audit_checks(run: dict, what: str):
    """The telescope balanced and no sweep reclaiming a pinned version,
    at the pin (before the release) and again after it, the delay
    histogram summing to the reclaimed count. Returns the event counts by
    state, the telescope and the GC report."""
    aud = run["eng"].auditor
    tel, gc = aud.telescope(), aud.gc_report()
    for when, (t_, g_) in (("at the pin", run["at_pin"]),
                           ("after the release", (tel, gc))):
        if not t_["balanced"] or g_["pin_stabbed_reclaims"] != 0:
            raise AssertionError(f"{what} {when}: telescope {t_}, gc {g_}")
    if sum(gc["delay_hist_log2"]) != gc["reclaimed"] or gc["reclaimed"] <= 0:
        raise AssertionError(f"{what}: gc report {gc}")
    states = {}
    for e in aud.events():
        states[e.state_name] = states.get(e.state_name, 0) + 1
    return states, tel, gc


def audited_path(cfg: dict, what: str, device="cuda",
                 R=YCSB_HIGH_10RMW.num_records,
                 t=YCSB_HIGH_10RMW.batch_size):
    """Phase 12 (a) / (b) on one configuration: the audited run, its
    unaudited twin (reads, pinned reads, store and launches byte-equal,
    as many host joins, as many synchronising operations inside
    ``run_batch``), the audit checks, then the same stream on the spill
    tier cut by ``AUDIT_SATURATE``, whose misses must all be explained.
    Returns what the phase prints."""
    runs, launches = {}, {}
    for audited in (True, False):
        kmod.reset_launches()
        runs[audited] = audit_stream(cfg, audited, device, R, t)
        _sync(device)
        launches[audited] = dict(kmod.LAUNCHES)
        if not audited:
            del runs[audited]["eng"]
    on, off = runs[True], runs[False]
    for i, (a, b) in enumerate(zip(on["reads"], off["reads"])):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: batch {i}")
    for a, b in zip(on["pinned"], off["pinned"]):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: pinned")
    for key in ("pinned_store", "store"):
        for name in on[key]:
            np.testing.assert_array_equal(on[key][name], off[key][name],
                                          err_msg=f"{what}: {key}/{name}")
    if launches[True] != launches[False]:
        raise AssertionError(f"{what}: launches {launches}")
    if (on["joins"], on["hot_syncs"]) != (off["joins"], off["hot_syncs"]):
        raise AssertionError(
            f"{what}: host joins audited {on['joins']} / {on['hot_syncs']} "
            f"against unaudited {off['joins']} / {off['hot_syncs']}; sync "
            f"sites only audited {dict(on['hot_sites'] - off['hot_sites'])}"
            f", only unaudited {dict(off['hot_sites'] - on['hot_sites'])}; "
            f"all {dict(on['hot_sites'])}")
    primary = "mvcc_resolve_paged" if cfg.get("paged") else "mvcc_resolve"
    if device == "cuda":
        check_in_place(what, launches[True], (primary,
                                              "mvcc_resolve_masked"))
    states, tel, gc = audit_checks(on, what)
    kmod.reset_launches()
    sat = audit_stream(dict(cfg, **AUDIT_SATURATE), True, device, R, t,
                       need_misses=True)
    _sync(device)
    sat_launches = dict(kmod.LAUNCHES)
    if device == "cuda":
        check_in_place(f"{what} (saturated)", sat_launches,
                       (primary, "mvcc_resolve_masked"))
    sat_states, _, sat_gc = audit_checks(sat, f"{what} (saturated)")
    sat_reasons, sat_found = sat["reasons"], float(sat["pinned"][1].mean())
    del sat
    # the timed runs: traced, without the sync count, unaudited and
    # audited alternating (off, on, on, off); per run the median batch and
    # phase ms of batches 3-9
    timed = {False: [], True: []}
    for audited in (False, True, True, False):
        run = audit_stream(cfg, audited, device, R, t, count_syncs=False,
                           traced=True)
        timed[audited].append(
            {"batch": statistics.median(run["batch_ms"][2:]),
             **{k: statistics.median(v[2:])
                for k, v in run["phase_ms"].items()}})
        del run
    return {"launches": launches[True], "joins": on["joins"],
            "hot_syncs": on["hot_syncs"], "states": states,
            "reasons": on["reasons"], "gc": gc, "telescope": tel,
            "harvest": on["harvest"],
            "timed": timed,
            "sat_reasons": sat_reasons, "sat_states": sat_states,
            "sat_gc": sat_gc, "sat_launches": sat_launches,
            "sat_found": sat_found}


def audited_service(device="cuda", R=YCSB_HIGH_10RMW.num_records,
                    t=YCSB_HIGH_10RMW.batch_size):
    """Phase 12 (c): ``TxnService`` in phase 9's ``ooo`` mode over
    ``SVC_AUDIT_BATCHES`` batches of its ``mixed`` stream, on an audited
    engine with an enabled tracer, a ``FlightRecorder`` and a
    ``HealthMonitor`` ticked after each ticket's wait; the stitched trace
    must validate with spans, async lanes and counter tracks, and the
    audit's invariants must hold after the drain."""
    batches = mixed_stream(np.random.default_rng(47), R, SVC_AUDIT_BATCHES,
                           t, OPS)
    eng = BohmEngine(R, make_ycsb(payload_words=YCSB_HIGH_10RMW
                                  .payload_words),
                     auditor=LifecycleAuditor(**AUDIT_KW),
                     tracer=PhaseTracer(enabled=True), device=device)
    flight = FlightRecorder(enabled=True)
    svc = TxnService(eng, flight=flight, **OOO_KW)
    monitor = HealthMonitor(svc, cadence_s=0.0)
    kmod.reset_launches()
    tickets = [svc.submit(b) for b in batches]
    pin = svc.begin_snapshot()
    for tk in tickets:
        svc.wait(tk)
        monitor.tick()
    svc.drain()
    scan = gen_scan_batch(np.random.default_rng(48), N_SCANS, R, ops=OPS,
                          theta=YCSB_HIGH_10RMW.theta, device=device)
    svc.run_readonly_batch(scan, pin)
    svc.release_snapshot(pin)
    eng.gc_sweep()
    monitor.sample()
    _sync(device)
    launches = dict(kmod.LAUNCHES)
    if device == "cuda":
        check_in_place("audited service", launches, ("mvcc_resolve",
                                                     "mvcc_resolve_masked"))
    trace = stitch_chrome_trace(eng.tracer, flight, monitor=monitor)
    counts = validate_chrome_trace(json.loads(json.dumps(trace)))
    if min(counts["spans"], counts["async_lanes"], counts["counters"]) <= 0:
        raise AssertionError(f"audited service: stitched trace {counts}")
    aud = eng.auditor
    tel, gc = aud.telescope(), aud.gc_report()
    if not tel["balanced"] or gc["pin_stabbed_reclaims"] != 0:
        raise AssertionError(f"audited service: {tel}, {gc}")
    return {"counts": counts, "epochs": len(svc.dispatch_log),
            "stats": {k: svc.stats[k] for k in SVC_COUNTERS},
            "alerts": monitor.alerts, "samples": monitor.samples,
            "events": len(aud.events()), "launches": launches}


def audit_replay(device="cuda", R=YCSB_HIGH_10RMW.num_records,
                 t=YCSB_HIGH_10RMW.batch_size, n_batches=4):
    """Phase 12 (d): (a)'s first ``n_batches`` batches (the pin after
    ``PIN_AFTER``) and a sweep on ``device`` and on the CPU: harvested
    events, state counts, the GC report and the telescope equal."""
    side = {}
    for dev in (device, "cpu"):
        run = audit_stream({}, True, dev, R, t, n_batches=n_batches,
                           sweeps=(n_batches,), release=False)
        aud = run["eng"].auditor
        side[dev] = ([dataclasses.astuple(e) for e in aud.events()],
                     aud.state_counts(), aud.gc_report(), aud.telescope())
        del run
    names = ("events", "state_counts", "gc_report", "telescope")
    for name, a, b in zip(names, side[device], side["cpu"]):
        if a != b:
            raise AssertionError(f"audit replay: {name} differs")
    return len(side["cpu"][0])


def audit_phase(device="cuda", R=YCSB_HIGH_10RMW.num_records,
                t=YCSB_HIGH_10RMW.batch_size, paged=PAGED):
    """Phase 12 (see the module doc); logs what it measured."""
    smi = nvidia_smi() if device == "cuda" else "cpu"
    t0 = time.perf_counter()
    for label, cfg in (("dense", {}), ("paged", paged)):
        t1 = time.perf_counter()
        res = audited_path(cfg, f"audited {label} path", device, R, t)
        h = res["harvest"]

        def ms(audited, key):
            return [round(r[key], 3) for r in res["timed"][audited]]
        log(f"audited {label} path: twin byte-equal (reads, pinned reads, "
            f"store, launches {res['launches']}); host joins "
            f"{res['joins']} and syncs inside run_batch {res['hot_syncs']}"
            f", equal off and on; events by state {res['states']}; pinned "
            f"reads of the {AUDIT_TOP} most-written records {res['reasons']}"
            f"; gc {res['gc']}; telescope balanced "
            f"({res['telescope']['lhs_committed_total']} versions)")
        log(f"audited {label} path: traced runs off, on, on, off — median "
            f"ms of batches 3-{N_BATCHES}, audited against unaudited: batch "
            f"{ms(True, 'batch')} against {ms(False, 'batch')}; "
            f"commit_phase {ms(True, 'commit_phase')} against "
            f"{ms(False, 'commit_phase')}; plan_phase "
            f"{ms(True, 'plan_phase')} against {ms(False, 'plan_phase')}; "
            f"exec_phase {ms(True, 'exec_phase')} against "
            f"{ms(False, 'exec_phase')}; harvest "
            f"{h['s'] * 1e3:.1f} ms for {h['events']} events in {h['n']} "
            f"harvests; saturated spill ({AUDIT_SATURATE}): found "
            f"{res['sat_found']:.4f}, every miss explained "
            f"{res['sat_reasons']}, events by state {res['sat_states']}, "
            f"gc pin-stabbed {res['sat_gc']['pin_stabbed_reclaims']}, "
            f"launches "
            f"{res['sat_launches']} ({time.perf_counter() - t1:.1f} s; "
            f"{smi})")
    t1 = time.perf_counter()
    svc = audited_service(device, R, t)
    log(f"audited service (ooo, {SVC_AUDIT_BATCHES} mixed batches): "
        f"stitched trace valid {svc['counts']}; epochs {svc['epochs']}; "
        f"{svc['stats']}; monitor samples {svc['samples']}, alerts "
        f"{svc['alerts']}; audit events {svc['events']}; launches "
        f"{svc['launches']} ({time.perf_counter() - t1:.1f} s; {smi})")
    t1 = time.perf_counter()
    n_events = audit_replay(device, R, t)
    log(f"audit cpu replay (4 batches, a pin after 3, a sweep): {n_events} "
        f"events, state counts, gc report and telescope card == cpu "
        f"({time.perf_counter() - t1:.1f} s)")
    log(f"audited store: {time.perf_counter() - t0:.1f} s; {smi}")


# ---------------------------------------------------------------------------
# the paper's remaining suites (phase 13)
# ---------------------------------------------------------------------------
# the suites whose card runs are counted, at the reference's points
PATH_SUITES = ("snapshot", "spill", "paged", "pipeline", "serving")
SNAPSHOT_R = 1_000_000


def suite_rows(name: str, device: str) -> list:
    """A suite's rows at the reference's points, ``--quick`` where the
    suite has it."""
    suite = importlib.import_module(f"benchmarks_torch.{name}")
    if name in ("spill", "paged", "pipeline"):
        return suite.run(quick=True, device=device)
    return suite.run(device=device)


def snapshot_at_scale(device: str, probe=None) -> list:
    """Snapshot's two YCSB cells (unpinned, pinned) at ``SNAPSHOT_R``
    records from one ``default_rng(29)``; ``probe`` goes to the pinned
    cell."""
    rng = np.random.default_rng(29)
    return [snapshot_suite.bench_cell("ycsb", pinned, rng, SNAPSHOT_R,
                                      device, probe if pinned else None)
            for pinned in (False, True)]


def check_rows(what: str, cpu: list, gpu: list) -> None:
    bad = row_mismatches(cpu, gpu, skip=("backend",))
    if bad:
        raise AssertionError(f"{what}: card rows differ from the cpu's: "
                             f"{bad}")


def suites_phase(device="cuda"):
    """Phase 13; returns the card's rows by suite and the launches
    (``device="cpu"`` rehearses it on the CPU against itself)."""
    with contextlib.redirect_stdout(io.StringIO()):   # the suites print
        cpu = {name: suite_rows(name, "cpu") for name in PATH_SUITES}
        cpu["snapshot_1m"] = snapshot_at_scale("cpu")
        cpu["microbench"] = suite_rows("microbench", "cpu")
        cpu["kernels"] = suite_rows("kernels", "cpu")
        kmod.reset_launches()                 # counts start at 0 here
        gpu = {name: suite_rows(name, device) for name in PATH_SUITES}
        probe = {}
        gpu["snapshot_1m"] = snapshot_at_scale(device, probe)
        gpu["microbench"] = suite_rows("microbench", device)
        _sync(device)
        launches = dict(kmod.LAUNCHES)
        gpu["kernels"] = suite_rows("kernels", device)
    check_in_place("paper suites", launches, (
        "mvcc_resolve", "mvcc_resolve_masked", "mvcc_resolve_paged",
        "decode_attention", "flash_attention_causal"))
    for name in cpu:
        check_rows(name, cpu[name], gpu[name])
    if not all(r["allclose"] for r in gpu["kernels"]):
        raise AssertionError(f"kernels.py: {gpu['kernels']}")
    n_found = 0
    for scan, vals, found in probe["scans"]:
        want = probe["at_pin"][scan.read_set.long()]
        if not torch.equal(vals[found], want[found]):
            raise AssertionError("snapshot at 1M: a pinned scan read "
                                 "differs from the state at the pin")
        n_found += int(found.sum())
    log(f"snapshot at {SNAPSHOT_R:,} records: {n_found} of "
        f"{sum(f.numel() for _, _, f in probe['scans'])} pinned scan reads "
        f"found, each equal to the state at the pin")
    return gpu, launches


# ---------------------------------------------------------------------------
# the models path: every family's loss, prefill and decode step (phase 14)
# ---------------------------------------------------------------------------
# (architecture, depth cut or None): each at full width, whole but grok,
# whose 64 layers (~628 GB in bf16) need 8 cards
MODEL_ARCHS = (("mamba2-370m", None), ("hymba-1.5b", None),
               ("seamless-m4t-large-v2", None),
               ("llava-next-mistral-7b", None),
               ("deepseek-v2-lite-16b", None), ("grok-1-314b", 2))
MODEL_B, MODEL_S, MODEL_MAX_LEN, MODEL_STEPS, MODEL_PREFILLS = \
    2, 512, 1024, 32, 3
# the float32 replay: 2 layers (grok 1: one float32 layer of its experts
# is 19.3 GB, so it runs on the card only), a prompt of 64 tokens, or one
# SSD chunk (256) where the model has SSM heads, 8 decode steps against
# the CPU
REPLAY_DEPTH = {"grok-1-314b": 1}
REPLAY_PROMPT, SSD_PROMPT, REPLAY_STEPS, REPLAY_TOL = 64, 256, 8, 1e-3
CARD_ONLY = ("grok-1-314b",)


def model_batch(cfg, n_tokens: int, n_extra: int, seed: int, device,
                labels: bool = True):
    """Random tokens (and labels) [B, n_tokens]; ``n_extra`` image
    patches (vlm) or audio frames (enc-dec) in the config's dtype; drawn
    with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def ints(n):
        return torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (MODEL_B, n)).astype(np.int32)).to(device)

    batch = {"tokens": ints(n_tokens)}
    if labels:
        batch["labels"] = ints(n_tokens)
    feat = {"patches": models_tf.VISION_EMBED_DIM,
            "frames": models_tf.AUDIO_FEAT_DIM}.get(cfg.frontend)
    if feat:
        x = rng.standard_normal((MODEL_B, n_extra, feat)).astype(np.float32)
        batch[cfg.frontend] = torch.from_numpy(x).to(
            device, getattr(torch, cfg.dtype))
    return batch


def fill_encoder_cache(cache, cfg, seed: int):
    """An enc-dec cache's ``enc_k`` / ``enc_v`` (zeros from
    ``init_cache``) drawn with numpy from ``seed``, the same values on
    any device, so cross-attention decode attends to data as a served
    request's encoder output would give it."""
    if cfg.enc_dec:
        rng = np.random.default_rng(seed)
        for name in ("enc_k", "enc_v"):
            x = rng.standard_normal(cache[name].shape).astype(np.float32)
            cache[name].copy_(torch.from_numpy(x))


def full_batch(cfg, device, labels=True):
    """B=2, S=512: llava 2,304 patches + 256 text tokens; seamless 512
    frames + 512 tokens."""
    if cfg.frontend == "patches":
        return model_batch(cfg, MODEL_S // 2, cfg.num_patches, 0, device,
                           labels)
    return model_batch(cfg, MODEL_S, MODEL_S, 0, device, labels)


def attention_layers(cfg):
    """(causal self-attention layers with no window: one
    flash_attention_causal launch each per forward; GQA decode attention
    calls per decode step: one decode_attention launch each; the other
    flash_attention calls per forward, which run the blockwise torch
    code: hymba's windowed layers, seamless's encoder and
    cross-attention)."""
    if cfg.family == "ssm":
        return 0, 0, 0
    if cfg.hybrid:
        n_global = len(cfg.global_attn_layers)
        return n_global, cfg.num_layers, cfg.num_layers - n_global
    if cfg.attention == "mla":
        return cfg.num_layers, 0, 0               # absorbed decode: einsums
    if cfg.enc_dec:
        return (cfg.num_layers, 2 * cfg.num_layers,
                cfg.encoder_layers + cfg.num_layers)
    return cfg.num_layers, cfg.num_layers, 0


class HeldCalls:
    """While open, wraps ``flash_attention_causal`` and
    ``decode_attention`` (the module attributes that ``models.layers``
    calls): records the (name, shape) of every launch, and while
    ``armed`` keeps the inputs and output of the latest launch at each
    shape and dtype (a decode cache is written in place, so they are
    copied); ``check`` then holds each kept output against the kernel's
    plain version on the same card tensors at phase 3's tolerances. Adds
    no launch."""
    NAMES = ("flash_attention_causal", "decode_attention")

    def __enter__(self):
        self.kept, self.shapes, self.armed = {}, set(), True
        self._saved = {n: getattr(ops, n) for n in self.NAMES}

        def keeper(name, kernel):
            def call(*args):
                out = kernel(*args)
                q, k = args[0], args[1]
                shape = (tuple(q.shape) if name == "flash_attention_causal"
                         else tuple(q.shape) + (k.shape[1],))
                self.shapes.add((name, shape))
                if self.armed:
                    self.kept[(name, shape, q.dtype)] = (
                        [a.clone() for a in args], out.clone())
                return out
            return call

        for n, fn in self._saved.items():
            setattr(ops, n, keeper(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(ops, n, fn)
        return False

    def check(self, what: str):
        """{"name shape dtype": max_abs_err} over the kept launches;
        raises where one disagrees with its plain version."""
        errs = {}
        for (name, shape, dtype), (args, out) in self.kept.items():
            ref = getattr(ops, name + "_plain")(*args)
            tol = ATT_TOL[(name, dtype)]
            torch.testing.assert_close(
                out.float(), ref.float(), rtol=tol, atol=tol,
                msg=lambda m: f"{what}: {name} {shape} {dtype}: {m}")
            errs[f"{name} {list(shape)} {str(dtype)[6:]}"] = \
                (out.float() - ref.float()).abs().max().item()
        self.kept = {}
        return errs


def phase3_shapes():
    """The (name, shape) pairs phase 3 holds in both dtypes."""
    return {("decode_attention", c) for c, _ in DECODE_CASES} | \
        {("flash_attention_causal", c) for c, _ in FLASH_CASES}


def _finite(x, what):
    if not torch.isfinite(x).all():
        raise AssertionError(f"{what}: not finite")


def model_bf16(name: str, depth, device="cuda"):
    """One configuration at full width in bf16: loss, MODEL_PREFILLS
    timed prefills, init_cache and MODEL_STEPS timed decode steps, then
    one warm step under the sync-debug mode. Launches and blockwise calls
    counted from zero; each kernel's latest launch at each shape in the
    loss and in the warm step (over MODEL_STEPS + 1 keys; seamless's
    encoder cache drawn from a seed) is held against its plain version,
    and every shape launched must be one phase 3 holds in both dtypes."""
    cfg = get_config(name)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in flatten(params).values())
    batch = full_batch(cfg, device)
    with HeldCalls() as held:
        ops.reset_launches()
        model_layers.reset_blockwise()
        loss = models_tf.loss_fn(params, batch, cfg)
        _finite(loss, f"{name} loss")
        batch.pop("labels")
        held.armed = False               # the timed runs copy nothing
        prefill_ms = []
        for _ in range(MODEL_PREFILLS):
            _sync(device)
            t0 = time.perf_counter()
            logits, _ = models_tf.prefill(params, batch, cfg)
            _sync(device)
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            _finite(logits, f"{name} prefill logits")
        cache = models_tf.init_cache(cfg, MODEL_B, MODEL_MAX_LEN,
                                     torch.bfloat16, device)
        fill_encoder_cache(cache, cfg, 3)
        toks = model_batch(cfg, MODEL_STEPS + 1, 0, 1, device,
                           labels=False)["tokens"]
        decode_ms, bad = [], []
        for i in range(MODEL_STEPS):
            _sync(device)
            t0 = time.perf_counter()
            logits, cache = models_tf.decode_step(params, cache,
                                                  toks[:, i:i + 1], cfg)
            _sync(device)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            bad.append((~torch.isfinite(logits)).sum())
        if int(torch.stack(bad).sum()):
            raise AssertionError(f"{name}: non-finite decode logits")
        joins = Joins()
        held.armed = True                # decode over MODEL_STEPS + 1 keys
        logits, cache = joins.hot(models_tf.decode_step, params, cache,
                                  toks[:, -1:], cfg)
        _finite(logits, f"{name} warm decode logits")
        _sync(device)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    blockwise = dict(model_layers.BLOCKWISE)
    n_flash, n_decode, n_blockwise = attention_layers(cfg)
    forwards = 1 + MODEL_PREFILLS
    want = {"flash_attention_causal": n_flash * forwards,
            "flash_attention_causal/wgmma": n_flash * forwards,
            "decode_attention": n_decode * (MODEL_STEPS + 1)}
    want = {k: v for k, v in want.items() if v and on_card}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    want = {"flash": n_blockwise * forwards, "decode": 0}
    if on_card and blockwise != want:
        raise AssertionError(f"{name}: blockwise calls {blockwise}, "
                             f"expected {want}")
    missing = held.shapes - phase3_shapes()
    if missing:
        raise AssertionError(f"{name}: kernel shapes phase 3 does not "
                             f"hold: {sorted(missing)}")
    held_errs = held.check(f"{name} bf16")
    if joins.hot_syncs:
        raise AssertionError(f"{name}: {joins.hot_syncs} synchronising "
                             f"operations in a warm decode_step "
                             f"{dict(joins.hot_sites)}")
    out = {"cfg": cfg, "init_s": init_s, "n_params": n_params,
           "loss": float(loss), "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "launches": launches,
           "blockwise": blockwise, "held": held_errs,
           "syncs": joins.hot_syncs,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if on_card else 0.0),
           "seq": (batch["tokens"].shape[1]
                   + (cfg.num_patches if cfg.frontend == "patches" else 0))}
    del params, cache, batch, logits
    torch.cuda.empty_cache()
    return out


def no_drop(cfg):
    """``cfg`` with an MoE capacity that drops nothing (capacity_factor =
    num_experts: C = tokens x k). A prefill over a prompt drops tokens
    past an expert's capacity, as the reference does, where a one-token
    decode step never does, so decode equals prefill only without
    drops."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def replay_run(params, cfg, device, whole_prompt: bool):
    """The float32 replay's outputs on ``device``: loss and prefill logits
    on a batch with extras, the logits of REPLAY_STEPS decode steps over
    its tokens from an empty cache, and with ``whole_prompt`` (not
    enc-dec) the last logits of a decode over the whole text-only prompt
    beside its prefill logits, both without MoE drops (``no_drop``)."""
    n = SSD_PROMPT if cfg.ssm is not None else REPLAY_PROMPT
    batch = model_batch(cfg, n, REPLAY_PROMPT, 2, device)
    out = {"loss": models_tf.loss_fn(params, batch, cfg)}
    batch.pop("labels")
    out["prefill"] = models_tf.prefill(params, batch, cfg)[0]
    cache = models_tf.init_cache(cfg, MODEL_B, n, torch.float32, device)
    fill_encoder_cache(cache, cfg, 4)
    steps = []
    for i in range(REPLAY_STEPS):
        logits, cache = models_tf.decode_step(
            params, cache, batch["tokens"][:, i:i + 1], cfg)
        steps.append(logits)
    out["decode"] = torch.stack(steps)
    if whole_prompt and not cfg.enc_dec:     # text only: decode == prefill
        tcfg = no_drop(cfg)
        text = {"tokens": batch["tokens"]}
        if cfg.frontend == "patches":
            text["patches"] = batch["patches"][:, :0]
        out["text_prefill"] = models_tf.prefill(params, text, tcfg)[0]
        cache = models_tf.init_cache(cfg, MODEL_B, n, torch.float32, device)
        for i in range(n):
            logits, cache = models_tf.decode_step(
                params, cache, batch["tokens"][:, i:i + 1], tcfg)
        out["text_decode"] = logits
    return {k: v.float().cpu() for k, v in out.items()}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def model_replay(name: str, device="cuda"):
    """``name`` at full width, REPLAY_DEPTH layers (2; the encoder cut
    alike), float32 with TF32 off: decode == prefill on the card, and the
    card against the CPU on the same weights (but grok)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    depth = REPLAY_DEPTH.get(name, 2)
    cfg = dataclasses.replace(get_config(name), num_layers=depth,
                              dtype="float32")
    if cfg.enc_dec:
        cfg = dataclasses.replace(cfg, encoder_layers=depth)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    before = dict(ops.LAUNCHES)
    with HeldCalls() as held:
        gpu = replay_run(params, cfg, device, True)
    moved = {k: ops.LAUNCHES[k] - before[k] for k in before
             if ops.LAUNCHES[k] != before[k]}
    res = {"depth": depth, "launches": moved,
           "held": held.check(f"{name} float32")}
    if "text_decode" in gpu:
        res["decode_vs_prefill"] = _rel(gpu["text_decode"],
                                        gpu["text_prefill"])
        if res["decode_vs_prefill"] > REPLAY_TOL:
            raise AssertionError(f"{name}: decode over the prompt differs "
                                 f"from prefill by {res['decode_vs_prefill']:.3g}")
    if name not in CARD_ONLY:
        params_cpu = unflatten({k: v.cpu() for k, v in
                                flatten(params).items()})
        del params
        torch.cuda.empty_cache()
        cpu = replay_run(params_cpu, cfg, "cpu", False)
        res["card_vs_cpu"] = {k: _rel(gpu[k], cpu[k]) for k in cpu}
        worst = max(res["card_vs_cpu"].values())
        if worst > REPLAY_TOL:
            raise AssertionError(f"{name}: card against cpu "
                                 f"{res['card_vs_cpu']}")
    else:
        del params
    for k, v in gpu.items():
        _finite(v, f"{name} replay {k}")
    torch.cuda.empty_cache()
    return res


def models_phase(device="cuda"):
    """Phase 14: every configuration of MODEL_ARCHS, one at a time."""
    smi = nvidia_smi()
    total = collections.Counter()
    for name, depth in MODEL_ARCHS:
        t0 = time.perf_counter()
        r = model_bf16(name, depth, device)
        total.update(r["launches"])
        cfg = r["cfg"]
        cut = (f"{cfg.num_layers} of {get_config(name).num_layers} layers "
               "(cut)" if depth else f"{cfg.num_layers} layers (whole)")
        log(f"models {name}: full width, {cut}, bf16, {r['n_params']:,} "
            f"parameters (init {r['init_s']:.2f} s); B={MODEL_B} S="
            f"{r['seq']}: loss {r['loss']:.4f}; prefill ms "
            f"{[round(x, 3) for x in r['prefill_ms']]} median "
            f"{statistics.median(r['prefill_ms']):.3f}; {MODEL_STEPS} "
            f"decode steps (max_len {MODEL_MAX_LEN}) median "
            f"{statistics.median(r['decode_ms']):.3f} ms (min "
            f"{min(r['decode_ms']):.3f}, max {max(r['decode_ms']):.3f}); "
            f"peak device memory {r['peak_gib']:.3f} GiB; launches "
            f"{r['launches']}; blockwise calls {r['blockwise']}; each "
            f"kernel shape against its plain version (max_abs_err) "
            f"{r['held']}; synchronising ops in a warm decode_step "
            f"{r['syncs']}; {smi}")
        rep = model_replay(name, device)
        log(f"models {name} replay: float32, {rep['depth']} layers: "
            f"decode over the prompt against prefill "
            f"{rep.get('decode_vs_prefill', 'n/a (enc-dec)')}; card "
            f"against cpu {rep.get('card_vs_cpu', 'n/a (card only)')} "
            f"(limit {REPLAY_TOL} of the largest magnitude); launches "
            f"{rep['launches']}, each shape against its plain version "
            f"(max_abs_err) {rep['held']} "
            f"({time.perf_counter() - t0:.1f} s)")
    return dict(total)


# ---------------------------------------------------------------------------
# the training path: smollm-360m at full width and depth (phase 15)
# ---------------------------------------------------------------------------
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SAVE_AT = "smollm-360m", 20, 10
# the float32 gradient replay: 2 layers of each family at full width, B=1
# and 32 tokens (256, one SSD chunk, with SSM heads; llava 32 patches +
# 32 tokens), MoE at a capacity that drops nothing
GRAD_ARCHS = ("smollm-360m", "hymba-1.5b", "seamless-m4t-large-v2",
              "llava-next-mistral-7b", "deepseek-v2-lite-16b")
GRAD_TOKENS, GRAD_TOL = 32, 1e-3


class HeldTraining:
    """While open, keeps (detached copies of) the inputs and output of the
    latest flash forward and backward launch of ``kernels.
    flash_attention`` while ``armed``; ``check`` holds them against the
    plain versions on the same card tensors. Adds no launch."""

    def __enter__(self):
        self.armed, self.fwd, self.bwd = False, None, None
        self._saved = (flash_mod._forward, flash_mod.flash_attention_causal_bwd)
        fwd, bwd = self._saved

        def keep_fwd(q, k, v):
            out = fwd(q, k, v)
            if self.armed and q.is_cuda:
                self.fwd = ([x.detach().clone() for x in (q, k, v)],
                            out.detach().clone())
            return out

        def keep_bwd(*args):
            grads = bwd(*args)
            if self.armed and args[0].is_cuda:
                self.bwd = ([x.detach().clone() for x in args],
                            [x.detach().clone() for x in grads])
            return grads

        flash_mod._forward = keep_fwd
        flash_mod.flash_attention_causal_bwd = keep_bwd
        return self

    def __exit__(self, *exc):
        flash_mod._forward, flash_mod.flash_attention_causal_bwd = \
            self._saved
        return False

    def check(self, what: str):
        """{"forward": err, "dq": ..., "dk": ..., "dv": ...}: the kept
        launches against the plain versions (phase 3's tolerances)."""
        (q, k, v), out = self.fwd
        ref = ops.flash_attention_causal_plain(q, k, v)
        tol = ATT_TOL[("flash_attention_causal", q.dtype)]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{what}: {m}")
        errs = {"forward": float((out.float() - ref.float()).abs().max())}
        args, grads = self.bwd
        for name, a, r in zip(("dq", "dk", "dv"), grads,
                              ops.flash_attention_causal_bwd_plain(*args)):
            rel = float((a.float() - r.float()).abs().max()
                        / r.float().abs().max().clamp(min=1e-30))
            if rel > BWD_TOL[args[0].dtype]:
                raise AssertionError(f"{what}: held backward {name} differs "
                                     f"by {rel:.3g} of its largest magnitude")
            errs[name] = rel
        return errs


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same_state(a, b, what):
    """Two state trees equal bit for bit (every leaf's dtype, shape and
    bits)."""
    fa, fb = flatten(a), flatten(b)
    if set(fa) != set(fb):
        raise AssertionError(f"{what}: names differ")
    for name, x in fa.items():
        y = fb[name]
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                *(t.reshape(-1).view(_BITS[t.element_size()])
                  for t in (x, y))):
            raise AssertionError(f"{what}: {name} differs")


def train_steps(device="cuda", cfg=None, batch=8, seq=2048,
                steps=TRAIN_STEPS, save_at=TRAIN_SAVE_AT):
    """``Trainer`` (remat "full", AdamW) over ``SyntheticTokenSource``:
    ``steps`` steps with the launches and blockwise calls of each step
    counted from zero; at ``save_at`` a save through ``CheckpointManager``,
    a restore into a fresh ``Trainer`` (parameters and optimizer state
    bit-equal) and one step of both on one batch (the losses compared);
    the latest flash forward and backward launch held against the plain
    versions. Returns what phase 15 prints."""
    from repro_torch.data.pipeline import (PackedBatchIterator,
                                           SyntheticTokenSource)
    from repro_torch.training.train_loop import TrainConfig, Trainer
    cfg = cfg or get_config(TRAIN_ARCH)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    data = PackedBatchIterator(SyntheticTokenSource(cfg.vocab_size, seed=0),
                               batch=batch, seq_len=seq)
    per_step = []

    def count(entry):
        per_step.append((dict(ops.LAUNCHES), dict(model_layers.BLOCKWISE)))
        ops.reset_launches()
        model_layers.reset_blockwise()

    with tempfile.TemporaryDirectory() as root, HeldTraining() as held:
        tcfg = TrainConfig(steps=steps, log_every=1, checkpoint_dir=root,
                           checkpoint_every=save_at)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, tcfg, data, device=device)
        _sync(device)
        init_s = time.perf_counter() - t0
        trainer.on_log = count
        ops.reset_launches()
        model_layers.reset_blockwise()
        trainer.run(save_at)                # saves at save_at
        t0 = time.perf_counter()
        fresh = Trainer(cfg, tcfg, data, device=device, seed=1)
        if not fresh.try_restore() or fresh.step != save_at:
            raise AssertionError("restore did not find the saved step")
        restore_s = time.perf_counter() - t0
        _same_state(fresh.params, trainer.params, "restored parameters")
        _same_state(fresh.opt_state, trainer.opt_state,
                    "restored optimizer state")
        # the pipeline's next batch through both: the original trainer
        # counts it as its step save_at + 1
        one = next(data)
        kept = trainer.data
        trainer.ckpt = fresh.ckpt = None
        fresh.on_log = lambda entry: None
        losses = []
        for t in (trainer, fresh):
            t.data = iter([one])
            losses.append(t.run(1)["loss"])
        del fresh
        trainer.data = kept
        ops.reset_launches()
        model_layers.reset_blockwise()
        trainer.run(steps - save_at - 2)
        held.armed = True                   # the last step's launches
        trainer.run(1)
        held_errs = held.check("training") if on_card else {}
    data.close()
    hist = trainer.history
    n_params = sum(x.numel() for x in flatten(trainer.params).values())
    return {"cfg": cfg, "hist": hist, "per_step": per_step,
            "losses_after_restore": losses, "init_s": init_s,
            "restore_s": restore_s, "held": held_errs, "n_params": n_params,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else 0.0)}


def check_train_launches(cfg, per_step, on_card=True):
    """Per step: 2 x layers forward launches (the remat recompute), one
    backward call (three kernels) a layer on the wgmma route, no
    blockwise call."""
    n = cfg.num_layers
    want = {"flash_attention_causal": 2 * n,
            "flash_attention_causal/wgmma": 2 * n,
            "flash_attention_causal_bwd": n,
            "flash_attention_causal_bwd/wgmma": n}
    want.update({f"flash_attention_causal_bwd/{k}": n
                 for k in flash_mod.BWD_KERNELS})
    for i, (launches, blockwise) in enumerate(per_step):
        got = {k: v for k, v in launches.items() if v}
        if on_card and got != want:
            raise AssertionError(f"training step {i + 1}: launches {got}, "
                                 f"expected {want}")
        if on_card and blockwise["flash"] != 0:
            raise AssertionError(f"training step {i + 1}: blockwise calls "
                                 f"{blockwise}")
    return want


def grad_replay(name: str, device="cuda"):
    """``name`` at full width and 2 layers (the encoder cut alike), float32
    with TF32 off, MoE without drops: ``value_and_grad`` of ``loss_fn`` on
    the card against the CPU on the same weights and batch; each leaf
    within GRAD_TOL of its largest magnitude. Returns the launches, the
    worst leaf and the loss on each device."""
    from repro_torch.training.train_loop import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = no_drop(dataclasses.replace(get_config(name), num_layers=2,
                                      dtype="float32"))
    if cfg.enc_dec:
        cfg = dataclasses.replace(cfg, encoder_layers=2)
    n = SSD_PROMPT if cfg.ssm is not None else GRAD_TOKENS
    rng = np.random.default_rng(7)
    batch_np = {"tokens": rng.integers(1, cfg.vocab_size, (1, n)),
                "labels": rng.integers(1, cfg.vocab_size, (1, n))}
    feat = {"patches": models_tf.VISION_EMBED_DIM,
            "frames": models_tf.AUDIO_FEAT_DIM}.get(cfg.frontend)
    if feat:
        batch_np[cfg.frontend] = rng.standard_normal(
            (1, GRAD_TOKENS, feat)).astype(np.float32)

    def to(dev):
        return {k: torch.from_numpy(v.astype(np.float32) if k == cfg.frontend
                                    else v.astype(np.int32)).to(dev)
                for k, v in batch_np.items()}

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(3),
                         device)
    before = dict(ops.LAUNCHES)
    loss, grads = value_and_grad(params, to(device), cfg)
    _sync(device)
    moved = {k: ops.LAUNCHES[k] - before[k] for k in before
             if ops.LAUNCHES[k] != before[k]}
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpu = flatten(grads)
    params_cpu = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    del params
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the CPU keeps every activation: remat changes no gradient (tests)
    cpu_loss, cpu_grads = value_and_grad(
        params_cpu, to("cpu"), dataclasses.replace(cfg, remat="none"))
    cpu_s = time.perf_counter() - t0
    # compared on the card: a pass over a billion CPU floats takes seconds
    t0 = time.perf_counter()
    cpu = {k: v.to(device) for k, v in flatten(cpu_grads).items()}
    del params_cpu, cpu_grads, grads
    # SSD's exp over the masked upper triangle overflows in a 256-step
    # chunk and its gradient turns NaN, in the reference too (ROADMAP,
    # known limits): the card must be non-finite exactly where the CPU is
    finite = {k: torch.isfinite(g) for k, g in cpu.items()}
    floor = 1e-6 * max(float(g[finite[k]].abs().max())
                       for k, g in cpu.items() if finite[k].any())
    worst, nonfinite = (0.0, ""), []
    for k, g in cpu.items():
        fin = finite[k]
        if not torch.equal(fin, torch.isfinite(gpu[k])):
            raise AssertionError(f"{name}: card gradient {k} is non-finite "
                                 "where the cpu's is not, or the reverse")
        if not fin.all():
            nonfinite.append(k)
        if not fin.any():
            continue
        rel = float((gpu[k][fin] - g[fin]).abs().max()
                    / max(float(g[fin].abs().max()), floor, 1e-30))
        worst = max(worst, (rel, k))
    n_leaves = len(cpu)
    del gpu, cpu
    torch.cuda.empty_cache()
    compare_s = time.perf_counter() - t0
    if worst[0] > GRAD_TOL:
        raise AssertionError(f"{name}: card gradient {worst[1]} differs "
                             f"from the cpu's by {worst[0]:.3g}")
    if abs(float(loss) - float(cpu_loss)) > GRAD_TOL * abs(float(cpu_loss)):
        raise AssertionError(f"{name}: loss card {float(loss)} cpu "
                             f"{float(cpu_loss)}")
    return {"launches": moved, "worst": worst, "loss": float(loss),
            "cpu_loss": float(cpu_loss), "tokens": n,
            "nonfinite": nonfinite, "leaves": n_leaves,
            "seconds": {"card": card_s, "copy": copy_s, "cpu": cpu_s,
                        "compare": compare_s}}


def training_phase(device="cuda"):
    """Phase 15 (see the module doc). Returns the launches of the bf16
    run's steps."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    smi = nvidia_smi()
    t0 = time.perf_counter()
    r = train_steps(device)
    cfg, hist = r["cfg"], r["hist"]
    want = check_train_launches(cfg, r["per_step"])
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    a, b = r["losses_after_restore"]
    if a != b:
        raise AssertionError(f"the step after the restore: loss {b} "
                             f"against the original trainer's {a}")
    ms = [h["step_time_s"] * 1e3 for h in hist]
    med = statistics.median(ms[1:])
    tokens = hist[0]["tokens"]
    rate = tokens / med * 1e3
    share = 6 * r["n_params"] * rate / PEAK_FLOPS_BF16
    total = collections.Counter()
    for launches, _ in r["per_step"]:
        total.update({k: v for k, v in launches.items() if v})
    log(f"training {TRAIN_ARCH}: full width and depth ({cfg.num_layers} "
        f"layers), bf16, remat {cfg.remat}, {r['n_params']:,} parameters "
        f"(init {r['init_s']:.2f} s); B=8 S=2048 on SyntheticTokenSource, "
        f"{len(hist)} AdamW steps; losses {[round(x, 4) for x in losses]}; "
        f"grad norms {[round(h['grad_norm'], 3) for h in hist]}")
    log(f"training: step ms {[round(x, 1) for x in ms]}; median (steps "
        f"2-{len(hist)}) {med:.3f} ms = {rate:.1f} tokens/s = "
        f"{100 * share:.2f} % of the bf16 peak (6 N tokens / step time); "
        f"peak device memory {r['peak_gib']:.3f} GiB; {smi}")
    log(f"training: launches per step {want} in each of the "
        f"{len(r['per_step'])} counted steps, 0 blockwise calls; total "
        f"{dict(total)}; the latest forward and backward launch against "
        f"the plain versions {r['held']}")
    log(f"training: save at step {TRAIN_SAVE_AT} and restore into a fresh "
        f"Trainer ({r['restore_s']:.2f} s): parameters and optimizer state "
        f"bit-equal; the next step on one batch: loss {b} == {a} (the "
        f"original trainer's)")
    for name in GRAD_ARCHS:
        t1 = time.perf_counter()
        g = grad_replay(name, device)
        log(f"training replay {name}: float32, 2 layers, B=1, "
            f"{g['tokens']} tokens: loss card {g['loss']:.6f} cpu "
            f"{g['cpu_loss']:.6f}; worst gradient leaf {g['worst'][1]} at "
            f"{g['worst'][0]:.3g} of its largest magnitude (limit "
            f"{GRAD_TOL}); leaves with NaN on both devices at the same "
            f"places {len(g['nonfinite'])} of {g['leaves']} "
            f"{g['nonfinite']}; launches {g['launches']} "
            f"({time.perf_counter() - t1:.1f} s: "
            f"{ {k: round(v, 2) for k, v in g['seconds'].items()} })")
    log(f"training phase: {time.perf_counter() - t0:.1f} s; {nvidia_smi()}")
    return dict(total), med


# ---------------------------------------------------------------------------
# the roofline of the training step and the sharded path (phase 16)
# ---------------------------------------------------------------------------
#: fake peak per device against the measured peak of the same step: the
#: allocator rounds each block up and keeps cuBLAS workspaces, which the
#: fake run's storages do not show
PEAK_TOL = 0.15
COUNT_KEYS = ("flops", "dot_flops", "bytes", "bytes_fused")


def roofline_terms(costs: dict, model_flops: float) -> dict:
    """The roofline terms of one step on one card (``launch.roofline``'s
    model): compute, memory and fused memory in ms, the bound (the
    larger of compute and memory) and the fused bound."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS_BF16
    t = {"compute_ms": costs["flops"] / PEAK_FLOPS_BF16 * 1e3,
         "memory_ms": costs["bytes"] / HBM_BW * 1e3,
         "memory_fused_ms": costs["bytes_fused"] / HBM_BW * 1e3,
         "useful_ratio": model_flops / costs["flops"]}
    t["bound_ms"] = max(t["compute_ms"], t["memory_ms"])
    t["bound_fused_ms"] = max(t["compute_ms"], t["memory_fused_ms"])
    return t


def train_step_counts(device="cuda", cfg=None, batch=8, seq=2048):
    """Phase 15's step counted on fake tensors (``dryrun.measure``), then
    the same counter over one real step on the same shapes. Returns the
    fake measure, the live counts, the measured peak GiB and seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import counting, dryrun, specs
    from repro_torch.training.optimizer import init_opt_state
    cfg = cfg or get_config(TRAIN_ARCH)
    shape = {"seq": seq, "batch": batch, "kind": "train"}
    fake = FakeTensorMode()
    t0 = time.perf_counter()
    fn, args, _ = specs.build_cell(TRAIN_ARCH, "train_4k", None, cfg=cfg,
                                   shape=shape, device=device,
                                   fake_mode=fake)
    fake_run = dryrun.measure(fn, args, fake)
    fake_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(16)
    params = init_params(cfg, gen, device)
    opt_state = init_opt_state(params)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device, dtype=torch.int32)
    real = {"tokens": tokens, "labels": tokens}
    on_card = torch.device(device).type == "cuda"
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    live = counting.dispatch_costs(fn, params, opt_state, real)
    _sync(device)
    live_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    del params, opt_state
    return fake_run, live, peak, fake_s, live_s


def dtensor_step(device="cuda"):
    """Reduced smollm-360m's ``value_and_grad`` on plain tensors and on
    DTensors of a (1, 1) mesh over a real one-rank process group; returns
    the launches of each and whether every bit agreed."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.constraints import activation_mesh
    from repro_torch.training.train_loop import value_and_grad
    cfg = reduced_config(TRAIN_ARCH)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(device)
        gen = torch.Generator(device=device).manual_seed(16)
        params = init_params(cfg, gen, device)
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                               device=device, dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens}
        ops.reset_launches()
        loss0, g0 = value_and_grad(params, batch, cfg)
        _sync(device)
        plain_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        specs = flatten(shd.param_shardings(cfg, mesh))
        dparams = unflatten({
            k: distribute_tensor(v, mesh, shd.placements(specs[k], mesh))
            for k, v in flatten(params).items()})
        dbatch = {k: distribute_tensor(v, mesh, shd.placements(
            shd.batch_sharding(mesh, tuple(v.shape)), mesh))
            for k, v in batch.items()}
        ops.reset_launches()
        with implicit_replication(), activation_mesh(mesh):
            loss1, g1 = value_and_grad(dparams, dbatch, cfg)
        _sync(device)
        dt_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        full = unflatten({k: v.full_tensor()
                          for k, v in flatten(g1).items()})
        _same_state({"loss": loss0}, {"loss": loss1.full_tensor()},
                    "DTensor loss")
        _same_state(g0, full, "DTensor gradients")
        return plain_launches, dt_launches, float(loss0)
    finally:
        dist.destroy_process_group()


def dryrun_local(arch=TRAIN_ARCH, timeout=300):
    """``python -m repro_torch.launch.dryrun --mesh local`` for ``arch``
    in a process of its own (its fake process group is its own); returns
    the records and the roofline rows."""
    from repro_torch.launch import roofline
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun.json"
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "local", "--out", str(out)], env=env,
            cwd=root, capture_output=True, text=True, timeout=timeout)
        if run.returncode != 0:
            raise AssertionError(f"dryrun exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        records = json.loads(out.read_text())
        rows = roofline.load_table(str(out), "local")
    return records, rows, run.stdout


def roofline_phase(step_ms: float, device="cuda"):
    """Phase 16 (see the module doc)."""
    from repro_torch.launch import roofline
    smi = nvidia_smi()
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    fake_run, live, peak_gib, fake_s, live_s = train_step_counts(device)
    costs = fake_run["jaxpr"]
    for k in COUNT_KEYS:
        if live[k] != costs[k]:
            raise AssertionError(f"live {k} {live[k]} != fake {costs[k]}")
    if live["kernels"] != fake_run["kernels"]:
        raise AssertionError(f"live kernel calls {live['kernels']} != fake "
                             f"{fake_run['kernels']}")
    fake_gib = fake_run["memory"]["peak_bytes_per_device"] / 2 ** 30
    mem_err = abs(fake_gib - peak_gib) / peak_gib
    if mem_err > PEAK_TOL:
        raise AssertionError(f"fake peak {fake_gib:.3f} GiB vs measured "
                             f"{peak_gib:.3f} GiB: {mem_err:.3f} > "
                             f"{PEAK_TOL}")
    tokens = 8 * 2048
    model_flops = 6 * cfg.num_params() * tokens
    t = roofline_terms(costs, model_flops)
    log(f"roofline of phase 15's step ({TRAIN_ARCH}, B=8 S=2048, bf16, "
        f"remat {cfg.remat}; H100 model {roofline.PEAK_FLOPS_BF16:.3g} "
        f"FLOP/s bf16, {roofline.HBM_BW:.3g} B/s HBM): counted flops "
        f"{costs['flops']:.6g} (dot {costs['dot_flops']:.6g}), bytes "
        f"{costs['bytes']:.6g}, fused bytes {costs['bytes_fused']:.6g}, "
        f"kernel calls {fake_run['kernels']}; compute {t['compute_ms']:.3f}"
        f" ms, memory {t['memory_ms']:.3f} ms, fused memory "
        f"{t['memory_fused_ms']:.3f} ms; useful ratio (6 N tokens = "
        f"{model_flops:.6g} flop / counted) {t['useful_ratio']:.4f}; bound "
        f"{t['bound_ms']:.3f} ms (fused {t['bound_fused_ms']:.3f} ms); "
        f"measured median step (phase 15) {step_ms:.3f} ms: bound / step "
        f"{t['bound_ms'] / step_ms:.4f}, fused bound / step "
        f"{t['bound_fused_ms'] / step_ms:.4f}; {smi}")
    log(f"roofline: one real step counted live gives the same counts "
        f"({live_s:.2f} s; the fake count {fake_s:.2f} s); fake peak per "
        f"device {fake_gib:.3f} GiB vs torch.cuda.max_memory_allocated "
        f"{peak_gib:.3f} GiB: {100 * mem_err:.2f} % (limit "
        f"{100 * PEAK_TOL:.0f} %); fake memory {fake_run['memory']}; {smi}")
    t1 = time.perf_counter()
    plain_l, dt_l, loss = dtensor_step(device)
    if plain_l != dt_l or not dt_l.get("flash_attention_causal") or \
            not dt_l.get("flash_attention_causal_bwd"):
        raise AssertionError(f"DTensor launches {dt_l} vs plain {plain_l}")
    log(f"sharded path: reduced {TRAIN_ARCH} loss {loss:.6f} and gradients "
        f"on DTensors of a (1, 1) mesh over a one-rank process group "
        f"bit-equal to the plain tensors'; launches {dt_l} (plain "
        f"{plain_l}); {time.perf_counter() - t1:.1f} s; {smi}")
    t1 = time.perf_counter()
    records, rows, _ = dryrun_local()
    bad = {k: r["status"] for k, r in records.items()
           if r["status"] not in ("ok", "skipped")}
    if bad or len(rows) != 3:
        raise AssertionError(f"dry run cells {bad}, {len(rows)} rows")
    log(f"dry run --mesh local, {TRAIN_ARCH} ({time.perf_counter() - t1:.1f}"
        f" s): " + "; ".join(
            f"{k} peak {r['memory']['peak_bytes_per_device'] / 2 ** 30:.3f} "
            f"GiB, run {r['compile_s']} s, kernels {r['kernels']}"
            for k, r in records.items() if r["status"] == "ok"))
    for r in rows:
        log(f"roofline row: {roofline.fmt_row(r)}; {smi}")
    log(f"roofline phase: {time.perf_counter() - t0:.1f} s; {nvidia_smi()}")


def ptxas_summary(nvcc_out: str):
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its mangled
    name (namespace prefix cut), spills and registers."""
    lines = nvcc_out.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and i + 2 < len(lines):
            fn = line.split("Function properties for", 1)[1].strip()
            fn = fn[fn.find("_cu_") + 13:].lstrip("0123456789") \
                if "_cu_" in fn else fn
            used = lines[i + 2].split(":", 1)[-1].strip()
            yield f"{fn[:90]} | {lines[i + 1].strip()} | {used}"


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
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        built = list(pool.map(_build.build, SOURCES))
    log(f"build: {len(SOURCES)} sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (path, nvcc_out) in zip(SOURCES, built):
        log(f"  {name}: {path}")
        for line in ptxas_summary(nvcc_out):
            log(f"    ptxas: {line}")

    rows = kernel_phase()
    t0 = time.perf_counter()
    rows.update(attention_phase())
    log(f"attention kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["flash_attention_causal_bwd"] = bwd_attention_phase()
    log(f"attention backward kernel: {time.perf_counter() - t0:.1f} s")

    kmod.reset_launches()                  # counts start at 0 for the path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gpu = drive("cuda", check_oracle=True)
    wall = time.perf_counter() - t0
    launches = dict(kmod.LAUNCHES)
    check_in_place("main path", launches, ("mvcc_resolve",
                                           "mvcc_resolve_masked"))
    for name in ("mvcc_resolve", "mvcc_resolve_masked"):
        rows[name]["launches"] = launches[name]
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
    check_in_place("paged path", launches, ("mvcc_resolve_paged",
                                            "mvcc_resolve_masked"))
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

    # -- the serving path, counted from zero ------------------------------
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    srv = drive_serving(get_config(SERVE_ARCH))
    launches = dict(ops.LAUNCHES)
    check_in_place("serving path", launches, (
        "decode_attention", "flash_attention_causal", "mvcc_resolve",
        "mvcc_resolve_masked"))
    for name in ("decode_attention", "flash_attention_causal"):
        rows[name]["launches"] = launches[name]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sp = srv["spans_ms"]
    # every bf16 prefill through the tensor-core flash kernel, every
    # decode step and prefix hit through decode_attention, once a layer
    layers = get_config(SERVE_ARCH).num_layers
    n_prefill, n_decode = len(sp["serve/prefill"]), len(sp["serve/decode"])
    n_hit = len(sp.get("serve/logits_at", []))
    want = {"flash_attention_causal/wgmma": layers * n_prefill,
            "flash_attention_causal/cuda_cores": 0,
            "decode_attention": layers * (n_decode + n_hit)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"serving path launches {got}, expected {want}")
    log(f"serving path: kernel variants {got} = {layers} layers x "
        f"({n_prefill} prefills; {n_decode} decode steps + {n_hit} prefix "
        f"hits)")
    dec, flush = sp["serve/decode"], sp["serve/state_flush"]
    wall = sum(srv["wave_s"])
    log(f"serving path: {SERVE_ARCH} full width, bf16, ServeEngine "
        f"defaults; params init {srv['init_s']:.2f} s; launches {launches}; "
        f"scheduler stats {srv['stats']}; health {srv['health']}; "
        f"decode steps {srv['steps']}; state store ts {srv['state_ts']}")
    prefill = [(n, round(x, 3)) for n, x in zip(srv["prefill_lens"],
                                                 sp["serve/prefill"])]
    log(f"serving path: prefill ms per prompt (tokens, ms) {prefill}; "
        f"prefix-hit _logits_at ms "
        f"{[round(x, 3) for x in sp.get('serve/logits_at', [])]}")
    dec_ms, flush_ms = statistics.median(dec), statistics.median(flush)
    log(f"serving path: decode step ms median {dec_ms:.3f} "
        f"(min {min(dec):.3f}, max {max(dec):.3f}, {len(dec)} steps); state "
        f"store batch (_flush_state) ms per step median {flush_ms:.3f} = "
        f"{100 * flush_ms / (dec_ms + flush_ms):.1f}"
        f" % of decode + flush; of it plan/exec/commit medians "
        f"{[round(statistics.median(sp[k]), 3) for k in PHASES]} ms; "
        f"read/resolve ms {[round(x, 3) for x in sp.get('read/resolve', [])]}")
    log(f"serving path: {srv['tokens']} tokens generated in {wall:.3f} s "
        f"(waves {srv['wave_s'][0]:.3f} + {srv['wave_s'][1]:.3f} s, "
        f"traced) = {srv['tokens'] / wall:.1f} tokens/s; peak device "
        f"memory {peak:.3f} GiB; all 16 requests done with "
        f"{SERVE_NEW} tokens, lookups and progress views consistent, pinned "
        f"view stable, logits finite")

    t0 = time.perf_counter()
    rel, tokens, routes = serving_replay(get_config(SERVE_ARCH))
    log(f"serving replay ({REPLAY_LAYERS} of 32 layers, float32): card == "
        f"cpu tokens {tokens}; flash routes {routes}; last logits within "
        f"{rel:.3g} of their "
        f"largest magnitude; lookups, progress view and state-store arrays "
        f"byte-equal ({time.perf_counter() - t0:.1f} s)")

    # -- the service path, counted from zero ------------------------------
    t0 = time.perf_counter()
    runs, launches, replay_s = service_phase()
    smi_now = nvidia_smi()
    n_txn = SVC_BATCHES * YCSB_HIGH_10RMW.batch_size
    log(f"service path: launches {launches}; every mode equals run_batch in "
        f"submission order (reads) and in its dispatch order (pinned "
        f"read-only batch; rings and heads after a sweep, the spill pool "
        f"too where no epoch merged); ooo cpu replay of {SVC_REPLAY} "
        f"batches byte-equal ({replay_s:.1f} s)")
    for name, _ in SVC_MODES:
        run, sp = runs[name], runs[name]["spans_ms"]
        med = {k: round(statistics.median(sp[k]), 3) for k in PHASES}
        log(f"service {name}: {n_txn / run['wall']:.1f} txn/s committed "
            f"({run['wall'] * 1e3:.3f} ms for {SVC_BATCHES} batches); epochs "
            f"{len(run['log'])}; "
            f"{ {k: run['stats'][k] for k in SVC_COUNTERS} }; traced "
            f"median phase ms {med}; {smi_now}")
    log(f"service ooo: dispatch_log {runs['ooo']['log']}; flight p50/p99 "
        f"ms {flight_breakdown(runs['ooo']['flight'])}; health "
        f"{runs['ooo']['health']}")
    log(f"service path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name, stats, ms, rate in baselines_phase():
        log(f"baseline {name}: {stats}; {ms:.3f} ms a batch on the card "
            f"(warm) = {rate:.1f} committed txn/s; card == cpu "
            f"(base, reads, stats)")
    log(f"baselines: {time.perf_counter() - t0:.1f} s")

    # -- the protocol arena, counted from zero -----------------------------
    t0 = time.perf_counter()
    grows, flagged = gauntlet_phase()
    log(f"arena gauntlet: {len(grows)} rows, all as expected; flagged "
        f"{sorted(flagged)}; card == cpu in every field "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    rows_a, launches, replay_s = arena_phase()
    log(f"arena path: launches {launches}; ycsb-10rmw-z0.9 serial-equivalent"
        f" and exact for all {len(PROTOCOL_NAMES)} protocols; certification"
        f" streams (committed, masks, read tags, final tags) and the pinned"
        f" scans card == cpu ({replay_s:.1f} s of cpu replay)")
    log(markdown_pivot(rows_a))
    for line in round_table(rows_a):
        log(f"arena {line}")
    check_headline(rows_a)
    log(f"arena: {time.perf_counter() - t0:.1f} s; {nvidia_smi()}")

    # -- the audited store, counted from zero per path ---------------------
    audit_phase()

    # -- the paper's remaining suites, counted from zero --------------------
    t0 = time.perf_counter()
    suites, launches = suites_phase()
    card = card_line()
    log(f"paper suites: launches {launches}; every suite's card rows equal "
        f"its cpu rows outside the wall times; kernels.py allclose")
    for name, srows in suites.items():
        for r in srows:
            log(f"suite {name}: "
                f"{' '.join(f'{k}={v}' for k, v in r.items())}; {card}")
    with contextlib.redirect_stdout(io.StringIO()) as text:
        summarize.print_bench_tables()
        with tempfile.TemporaryDirectory() as root:
            bench_history.append_suites(root=Path(root))
    log(text.getvalue().rstrip())
    log(f"paper suites: {time.perf_counter() - t0:.1f} s; {card}")

    # -- the models path, counted from zero per configuration ---------------
    t0 = time.perf_counter()
    model_launches = models_phase()
    for name in ("decode_attention", "flash_attention_causal"):
        rows[name]["models_launches"] = model_launches.get(name, 0)
    log(f"models path: bf16 launches over the six configurations "
        f"{model_launches}; {time.perf_counter() - t0:.1f} s; {nvidia_smi()}")

    # -- the training path, counted from zero per step ----------------------
    train_launches, step_ms = training_phase()
    rows["flash_attention_causal_bwd"]["launches"] = \
        train_launches["flash_attention_causal_bwd"]
    rows["flash_attention_causal"]["training_launches"] = \
        train_launches["flash_attention_causal"]

    # -- the roofline of the training step and the sharded path -------------
    roofline_phase(step_ms)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
