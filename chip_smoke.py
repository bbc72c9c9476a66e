"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and ``nvcc``; imports neither JAX nor
the JAX package. Phases, each of which must pass:

1. environment: torch/CUDA versions, the card's name and power limit and
   the host's available memory;
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
   (deepseek-v2-lite's MLA prefill at Dh = 192, also at its training
   length S = 2,048, G = 5 and 6, seamless's 4,096-frame
   cross-attention) and phase 15's five family training shapes
   (``TRAIN_FAMILY_SHAPES``), gives the same bits on a second call,
   ignores a poisoned cache tail (decode), and is timed beside its plain
   version, its bound (float32 operations at ``TF32X3_OPS_PER_S``, the
   card's float32-accurate tensor rate) and one
   ``scaled_dot_product_attention(enable_gqa=True)`` call (the
   yardstick; the port never calls it); each case logs the kernel it
   launched, which must be the one its dtype and Dh pick (flash:
   ``wgmma`` for bf16 with Dh % 16 == 0, ``tf32x3`` for float32 with Dh
   % 8 == 0, else ``cuda_cores``; decode: ``split_cluster``); at each
   float32 flash case on ``tf32x3`` the CUDA-core kernel (the float32
   route before the tf32x3 one) is also held against the plain version
   on the same inputs and timed, and every float32 flash output is
   measured against a float64 softmax; float32 views 4 bytes off 16-byte
   alignment take ``cuda_cores`` and agree with the plain version; and
   the backward of
   ``flash_attention_causal`` (``flash_attention_causal_bwd``: three
   kernels, row statistics, dk/dv, dq; with 16-byte aligned tensors and
   Dh <= 192 the ``wgmma`` route on the tensor cores for bf16 with Dh %
   16 == 0, the ``tf32x3`` route (3xTF32 on the tensor cores) for
   float32 with Dh % 8 == 0, else ``cuda_cores``)
   against its plain version in
   float32 and bf16 at the reference tests' shapes, odd S, G = 1 and 3-7,
   Dh = 32-192 (36: the CUDA cores in float32 too), the training shapes
   (8, 2,048, 5, 3, 64), MLA's (2, 2,048, 16, 1, 192) and phase 15's
   five family shapes (G = 1, 4, 6, 8; llava's S = 3,328) and a case whose
   tensors sit 4 bytes (bf16: 2) off 16-byte alignment (the CUDA cores):
   within 2e-5
   (float32) and 1e-2 (bf16) of the plain gradient's largest magnitude,
   the same bits on a second call, one launch of each kernel and of the
   expected route, timed
   beside the plain version, its bound (q, k, v, out, dout, dq, dk, dv
   bytes; 10 Dh flops a visible pair) and one SDPA backward; at each
   float32 case on ``tf32x3`` the CUDA-core kernels
   (``flash_attention_bwd.cu``, the float32 route before it) are also
   held against the plain backward on the same inputs, through their own
   C functions, and timed;
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
   their in-place forms only): flash through its bf16
   tensor-core kernel once a layer for every prefill and never through
   the tf32x3 or CUDA-core ones, decode once a layer for every decode
   step and prefix hit. Prints prefill
   ms per prompt, decode-step ms, generated tokens/s, the state-store
   batch's ms per step and peak memory;
8. serving replay: the same engine at full width with depth cut to 4
   layers, float32 weights and KV, 4 requests of 64-128 tokens and 8 new
   tokens, on the card and on the CPU (plain versions); on the card
   every prefill takes flash's 3xTF32 tensor-core kernel (``tf32x3``;
   none ``wgmma`` or ``cuda_cores``): equal tokens,
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
   seamless-m4t-large-v2, llava-next-mistral-7b, deepseek-v2-lite-16b,
   mistral-nemo-12b, nemotron-4-15b (squared ReLU), qwen3-32b (qk-norm,
   G = 8; ~32.8 G parameters, ~61 GiB in bf16) (whole) and grok-1-314b
   (2 of 64 layers: the whole model needs 8 cards) at full width
   through ``repro_torch.models``, one at a time, freed before the
   next. In bf16 from a seeded ``torch.Generator``:
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
   tolerances, the bf16 shapes must be exactly those the config gives
   (``kernel_shapes``) and each one of phase 3's cases.
   Then a float32 replay (TF32
   off; every flash launch on the ``tf32x3`` route) at 2 layers (grok 1;
   the encoder cut alike): the last logits of
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
   against the plain versions. Then deepseek-v2-lite-16b's bf16 step at
   full width, cut to its first 2 of 27 layers (layer 0 dense, d_ff
   10,944; layer 1 MoE: 64 routed experts top-6 and 2 shared, capacity
   factor 1.25), remat "full", AdamW, B=2, S=2,048 on
   ``SyntheticTokenSource``, 5 steps, no save: losses finite; every step
   launches exactly 3 ``flash_attention_causal`` (the dense layer 0 runs
   outside remat, as in the reference; the MoE layer's is recomputed) and
   2 ``flash_attention_causal_bwd`` calls, all on the wgmma routes (MLA's
   backward at Dh = 192 on the tensor cores), and no blockwise call; the
   last step's latest forward and backward launch held against the plain
   versions. Then a float32 gradient replay (TF32 off)
   of smollm, hymba, seamless, llava and deepseek-v2-lite (MLA at Dh =
   192, MoE at a capacity that drops nothing) at full width and 2 layers,
   B=1 and 32 tokens (hymba one SSD chunk, 256; every flash forward on
   the ``tf32x3`` route, and exactly one ``flash_attention_causal_bwd``
   call a causal layer, all on its ``tf32x3`` route, none on the CUDA
   cores): the card's loss and gradients equal a CPU run
   of the same weights within 1e-3 of each leaf's largest magnitude,
   non-finite at the same places (hymba's SSD chunk overflows in the
   reference too: ROADMAP.md, known limits).
   Prints the median step ms, tokens/s, the share of the bf16 peak that
   6 N tokens / step time reaches, peak memory, launches and the held
   errors beside the card's name and power limit (for deepseek-v2-lite:
   the median of steps 2-5, tokens/s, ``max_memory_allocated`` and the
   cuts).
   Then the bf16 steps of five more families (``family_phase``), each at
   its published widths, cut to the deepest stack whose 12 B a parameter
   (bf16 weight and gradient, float32 AdamW moments) stay within 53 GiB
   (``family_config``; each cut printed with its reckoning):
   seamless-m4t-large-v2 whole (24 + 24 encoder layers), llava 20 of 32,
   mistral-nemo-12b 12 of 40, nemotron-4-15b 4 of 32 (squared ReLU; its
   256,000 x 6,144 embed and head), qwen3-32b 6 of 64 (qk-norm, G = 8).
   ``Trainer``, remat "full", AdamW, B=2, 2,048 text tokens from
   ``SyntheticTokenSource`` (llava 1,024 beside its 2,304 patches;
   seamless 2,048 audio frames beside them, ``FrontendBatches``: seeded
   numpy features in ``model_batch``'s layout), 4 steps, no save, each
   model freed before the next: losses finite; every step launches row 5
   twice and row 5b once a causal layer, all on wgmma, at the q shape
   the config gives, and exactly seamless's encoder and cross-attention
   calls (each forward and recompute) run blockwise
   (``train_step_launches``); the last step's forward and backward
   launch held against the plain versions. Prints each one's median step
   ms (steps 2-4), text tokens/s, the bf16-peak share of 6 N positions /
   step time, peak GiB and init seconds. The float32 replays above also
   hold mamba2-370m (SSD's backward, no attention; its 256-step chunk
   overflows to NaN in both packages), mistral-nemo-12b, nemotron-4-15b
   and qwen3-32b, stopping where the host cannot hold the CPU side.
   Then the trainer's options in process (``trainer_options``):
   smollm-360m at full width and 2 layers in float32 (TF32 off), one
   batch of 8 x 512: ``make_train_step`` with ``microbatch=2`` and
   without give loss and grad norm within 1e-5 (relative), the two
   halves' gradients summed in float32 and halved equal the whole
   batch's within 1e-5 of each leaf's largest magnitude, and
   ``compress_grads`` of the card's gradient is bit-equal to the same
   call on its CPU copy. Last, both launchers as subprocesses with this
   process's ``PYTHONPATH`` and build directory (``launchers_phase``):
   ``python -m repro_torch.launch.train --arch smollm-360m --steps 4
   --batch 8 --seq 2048 --microbatch 2 --compress-grads --log-every 1
   --ckpt <tmp>``, then the same with ``--resume`` (prints ``resumed from
   step 4``), every printed loss finite; ``python -m
   repro_torch.launch.serve --arch smollm-360m --requests 8
   --prompt-len 256 --max-new 16`` prints ``served 8 requests / 128
   tokens``; the build directory unchanged. Their lines are forwarded.

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
   Then ``python -m repro_torch.launch.dryrun --mesh local`` for
   smollm-360m's three supported shapes (each cell ``ok``) and their
   roofline rows, beside the card's name and power limit. Last, two
   production-mesh cells at published widths (``dryrun_production``):
   mistral-nemo-12b's ``decode_32k`` and ``prefill_32k`` on the (16, 16)
   (data, model) mesh, each in a process of its own, both started with
   the phase and held at its end (they are host work beside its steps). Its
   32 query heads shard over ``model`` and its 8 KV heads do not, so the
   kernels' group split gathers the heads first; each cell must be
   ``ok``, reach its kernel's operator once a layer, and hold its
   ``memory.argument_bytes`` equal to rank 0's bytes of parameters,
   batch and cache reckoned from the config and the sharding specs
   (``launch.specs.argument_bytes``).

17. the ``mesh=`` substrate: ``BohmEngine(mesh=)`` on a 4-rank ``cc``
   mesh (``launch.mesh.cc_mesh``) at the paper's scale —
   ``YCSB_HIGH_10RMW``: 1,000,000 records, 8 words, batches of 1,024
   zipfian (theta = 0.9) 10-RMW transactions, spill tier on; 5 batches,
   a pin after batch 2, a pinned ``snapshot_read`` of 1,024 zipfian
   records and one ``gc_sweep`` — on three storage substrates
   (``mesh_substrates``): the dense defaults; the paged path's own
   settings (``PAGED``: adaptive K to 16, 2M pages of 2 slots a shard);
   and the adaptive-K settings of ``tests/test_torch_mesh_engine.py``
   scaled to 1M records (K 4 to 8, 4 pages and one 16-slot spill bucket
   a record of a shard). With adaptive K the pin is then released and 3
   batches each end in a sweep (the policy's hysteresis). With one card
   the 4 ranks are threads over torch's threaded process group on it;
   with two or more, one process a card over NCCL (n = min(4, cards)).
   The phase prints its substrate. Each rank plans its records, holds
   and commits its quarter of the version store and resolves through
   the primary's row (1 dense, 3 paged: the rank's own page table read
   in place) and row 2 in their in-place forms (each rank's own
   launches count; no windows form, not the other primary's row), and
   holds both bit for bit against their plain versions on its own
   shard; with adaptive K the policy must have granted slots to every
   rank's records. The reads, found flags, pinned values, every sweep's
   count, ``k_by_record``, storage and spill stats, the engine's scalar
   counters and every store array (gathered; the page table included)
   must equal the logical engine's of the same 4 shards on the same
   stream, byte for byte. Prints each substrate's batch ms per rank
   beside the logical engine's and the phase's seconds beside the
   card's name and power limit.

18. the elastic restart: a first world of 4 ranks on a (2, 2) ("data",
   "model") ``DeviceMesh`` (``launch.mesh.device_mesh``) takes 3 AdamW
   steps with parameters, AdamW state and batch as DTensors placed by
   ``param_shardings``, ``opt_state_shardings`` and ``batch_sharding``
   (the step under ``activation_mesh`` and ``implicit_replication``) and
   saves through ``CheckpointManager`` (every rank gathers, rank 0
   writes); then a new world of ``plan_remesh(2, model_parallel=2)``'s 2
   ranks on (1, 2) restores with ``shardings=`` (each rank reading its
   own shards of the files), holds the restored state, gathered, to the
   files bit for bit, and takes 2 steps. Four configurations in each
   world: smollm-360m at 4 of its 32 layers (d_model 960, 15 / 5
   heads, Dh 64, vocab 49,152; cut to keep the smoke inside its time
   limit) in bf16, remat "full", B=8 x S=2,048 (its 5 KV heads
   do not divide ``model``, so rows 5 and 5b run on batch shards, on
   the ``wgmma`` routes); the same at 2 layers in float32, B=4 x S=512;
   reduced smollm-360m in float32, B=4 x S=256, whose 2 KV heads shard
   over ``model`` (rows 5 and 5b on head shards, on the ``tf32x3``
   routes); and the GQA-split case, the same reduced model in float32
   with 6 query and 3 KV heads (B=4 x S=256): ``model`` = 2 shards the
   query heads but not the KV heads, so the group split
   (``layers.split_groups``) gathers the query heads over ``model``
   first and rows 5 and 5b run on batch shards holding all 3 KV heads.
   The three float32 runs must match the same 5 steps run
   unsharded on one card: each loss, and the gradient at each world's
   start (the same parameters and batch), within 1e-3 (phase 15's
   float32 limit, worst leaf); the saved parameters after each world
   within 1e-3 of each leaf's largest magnitude but for isolated AdamW
   sign flips (at most 1e-5 of a leaf's elements, each within 0.62 lr
   a step, twice the reach measured on the H100: AdamW's first update
   of an element is ~lr x the sign of its gradient, which float32
   cannot resolve where a gradient sits at the runs' difference); the
   elements whose gradient at their first nonzero update lies below the
   sharded-unsharded start-gradient gap are counted and printed beside.
   The three float32 cases run again as the control replay
   (``f64_embed_grad``): the ``embed`` lookup's gradient summed in
   float64 over the whole batch in the sharded and the unsharded run
   alike, held as the default replay is. Step 1's gradient of the four
   runs (sharded or not, default or control) is then held against a
   float64 recomputation on the CPU (``embed_arbiter``, the model in
   float64 under ``float64_math``): each run's worst leaf within 1e-5
   and at most 1e-5 of ``embed``'s nonzero elements of another sign
   (``check_arbiter``), so that a wrong sharded gradient fails however
   close the unsharded one is.
   Every rank must launch rows 5
   and 5b exactly as its layers and steps need, all on the tensor-core
   route of the dtype (none on the CUDA cores), on local shards of the
   expected shape, with the last launch of each held against the plain
   versions. With 4 or more cards the ranks are processes, one a card,
   over NCCL; on one card they are threads of this process over the
   threaded process group (``thread_ranks``; each runs its backward on
   its own thread), as processes sharing a card over gloo crash in
   DTensor's collectives on torch 2.11 (a segfault in the functional
   collectives' wait). Prints the substrates, each world's step ms,
   peak GiB and launches per rank, kernel and route beside the card's
   name and power limit.

19. the sharded families (``sharded_phase``): the training step of the
   nine other families sharded as the reference shards them
   (``param_shardings``, ``batch_sharding``, under ``activation_mesh``
   and ``implicit_replication``), float32 with TF32 off, each held
   against the same step unsharded on the card. Reduced width
   (``configs.reduced_config``, B=4 x S=64, two AdamW steps): every
   family on (2, 2) ("data", "model") with sequence parallelism off and
   on, the two MoE families also on (2, 2, 1) ("pod", "data", "model"),
   the batch over two mesh dims, and reduced grok-1 with 3 experts
   (``expert_tp_config``: ``model`` = 2 does not divide them, so their
   d_ff shards over it) off and on; each step is held at equal inputs
   (the second from the sharded run's own state, ``equal_input_step``):
   loss and gradient within 1e-3 (GRAD_TOL, worst leaf), the parameters
   after within 1e-3 but for isolated AdamW sign flips (phase 18's
   rule), and the two-step trajectory is printed beside. Published
   width on (1, 2), off and on: each family but grok-1 (WIDE_SKIP) at 2
   layers, B=1, 32 tokens (256 with SSM heads; llava 32 patches
   beside), the step-1 gradient held shard by shard against the
   unsharded one (``local_agreement``): non-finite exactly where it is
   (SSD's overflow, in the reference too) and within 1e-3 elsewhere.
   The MoE router's expert sets must agree but at near-ties (a token
   whose set differs sits below 1e-6 in both runs); its smallest top-k
   margin is printed. Every rank launches rows 5 and 5b as its causal
   layers and steps need, on the tf32x3 routes only, on local shards of
   the expected shape, the last launch of each held against the plain
   versions. The ranks are ``elastic_launcher``'s (threads on one card,
   NCCL processes on enough cards). The phase runs in six processes
   of its own (SHARDED_PARTS: the reduced cases by mesh, SP and half of
   the families, then the published widths), started after phase 15's
   timed and held parts, beside its launchers and phases 16-18, and
   joined after phase 18. One line a case: family, mesh, SP, width and depth, worst error
   per quantity, flips, routing margin, step ms, peak GiB (the step's,
   the process's allocator) and launches by route, beside the card's
   name and power limit.

The line before the last is a JSON object with every kernel's launches,
error and times (rows 1-3 in the in-place form the read path launches,
the windows form's and the two call sites' times beside them), then the
card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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
from benchmarks_torch.dryrun_sweep import MESHES  # noqa: E402
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
           "flash_attention_bwd", "flash_attention_bwd_wgmma",
           "flash_attention_bwd_tf32x3")
# the backward is row 5's gradient: the reference has no Pallas backward
# (it differentiates its blockwise jnp attention, models/layers.py:114)
REPLACES = {"mvcc_resolve": "src/repro/kernels/mvcc_resolve.py:81",
            "mvcc_resolve_masked": "src/repro/kernels/mvcc_resolve.py:143",
            "mvcc_resolve_paged": "src/repro/kernels/mvcc_resolve.py:221",
            "decode_attention": "src/repro/kernels/decode_attention.py:63",
            "flash_attention_causal":
                "src/repro/kernels/flash_attention.py:77",
            "flash_attention_causal_bwd":
                "src/repro/kernels/flash_attention.py:77",
            "flash_attention_causal_bwd/tf32x3":
                "src/repro/kernels/flash_attention.py:77"}
ATT_SOURCE = {"decode_attention":
              "src/repro_torch/kernels/csrc/decode_attention.cu",
              "flash_attention_causal":
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "flash_attention_causal_bwd":
              "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
              "flash_attention_causal_bwd/tf32x3":
              "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32x3.cu"}
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


def host_free_gib() -> float:
    """The host's available memory (``MemAvailable``), GiB."""
    with open("/proc/meminfo") as f:
        kib = next(int(line.split()[1]) for line in f
                   if line.startswith("MemAvailable:"))
    return kib / 2 ** 20


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
# rows 5 and 5b at phase 15's bf16 training batches of five families
# (B=2; ``family_kernel_shape``): mistral-nemo, nemotron (G = 6), qwen3
# (G = 8), seamless's decoder, llava's 2,304 patches + 1,024 tokens
TRAIN_FAMILY_SHAPES = ((2, 2048, 8, 4, 128), (2, 2048, 8, 6, 128),
                       (2, 2048, 8, 8, 128), (2, 2048, 16, 1, 64),
                       (2, 3328, 8, 4, 128))
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
                # llava and mistral-nemo
                ((2, 8, 4, 128, 1024), "models"),
                ((2, 8, 6, 128, 1024), "models"),        # grok, nemotron
                # qwen3-32b, G = 8: the two-pass merge (G > 4)
                ((2, 8, 8, 128, 1024), "models")]
FLASH_CASES = [((1, 128, 1, 1, 32), "tests"), ((2, 256, 2, 3, 64), "tests"),
               ((1, 512, 4, 2, 128), "tests"), ((2, 128, 2, 1, 64), "tests"),
               ((1, 128, 5, 3, 64), "serving"),
               ((1, 384, 5, 3, 64), "serving"),
               ((1, 512, 5, 3, 64), "serving"), ((1, 300, 5, 3, 64), "odd"),
               ((2, 77, 2, 4, 40), "odd"),
               # float32 Dh % 8 != 0: the CUDA-core kernel in both dtypes
               ((2, 77, 2, 4, 36), "odd"),
               ((2, 512, 5, 5, 64), "models"),           # hymba's globals
               ((2, 512, 16, 1, 64), "models"),          # seamless
               ((2, 2560, 8, 4, 128), "models"),         # llava
               # deepseek-v2-lite's MLA prefill: 16 heads of 128 + 64,
               # v padded to it (G = 1)
               ((2, 512, 16, 1, 192), "models"),
               # its rows at deepseek's training length
               ((1, 2048, 16, 1, 192), "models"),
               ((2, 512, 8, 6, 128), "models"),          # grok, nemotron
               ((2, 512, 8, 4, 128), "models"),          # mistral-nemo
               ((2, 512, 8, 8, 128), "models")] + \
    [(c, "training") for c in TRAIN_FAMILY_SHAPES]
# a flash case whose float32 views phase 3 also passes 4 bytes off
# 16-byte alignment (the CUDA-core kernel takes them)
UNALIGNED_CASE = (1, 512, 5, 3, 64)
# the kernels line carries each kernel at its busiest serving shape, bf16
ROW_CASE = {"decode_attention": (8, 5, 3, 64, 1024),
            "flash_attention_causal": (1, 512, 5, 3, 64)}
ATT_TOL = {("decode_attention", torch.float32): 1e-5,
           ("decode_attention", torch.bfloat16): 2e-2,
           ("flash_attention_causal", torch.float32): 1e-5,
           ("flash_attention_causal", torch.bfloat16): 3e-2}
# The attention rows' float32 operations rate: the card's float32-accurate
# tensor rate, 3xTF32 (three tf32 products a float32 product, 495 / 3
# TFLOP/s), not the CUDA cores' 67: float32 attention can run there (the
# flash forward's tf32x3 route does), so the least time the card could
# take for it is counted at that rate.
TF32X3_OPS_PER_S = 495e12 / 3
PEAK = {torch.float32: TF32X3_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S}


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
    before it: flash's route (``wgmma`` / ``tf32x3`` / ``cuda_cores``),
    decode's one kernel (``split_cluster``)."""
    moved = {k for k, n in ops.LAUNCHES.items() if n != before[k]}
    if name == "decode_attention":
        assert moved == {name}, moved
        return "split_cluster"
    routes = [k.split("/")[1] for k in moved if k.startswith(name + "/")]
    assert name in moved and len(routes) == 1, moved
    return routes[0]


FLASH_ROUTES = ("wgmma", "tf32x3", "cuda_cores")


def flash_route_wanted(dtype, dh):
    """The flash kernel a call with 16-byte aligned tensors must take:
    ``wgmma`` for bf16 with Dh % 16 == 0, ``tf32x3`` for float32 with Dh
    % 8 == 0, else ``cuda_cores``."""
    if dtype == torch.bfloat16 and dh % 16 == 0:
        return "wgmma"
    if dtype == torch.float32 and dh % 8 == 0:
        return "tf32x3"
    return "cuda_cores"


def flash_cuda_cores_f32(q, k, v):
    """One launch of flash's float32 CUDA-core kernel through its own C
    function, whatever route the wrapper would pick: phase 3 holds and
    times it beside the tf32x3 kernel on the same inputs. Counts no
    launch (a comparison, not the path)."""
    b, s, kvh, g, dh = q.shape
    out = torch.empty_like(q)
    _build.call("flash_attention", "flash_attention_causal_f32",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_float],
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, kvh, g, dh, dh ** -0.5], q.device)
    return out


def attention_f64(q, k, v, block=256):
    """Causal GQA attention in float64 (an exact softmax, q block by q
    block): the yardstick of each float32 version's error."""
    b, s, kvh, g, dh = q.shape
    qd, kd, vd = q.double() * dh ** -0.5, k.double(), v.double()
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for q0 in range(0, s, block):
        q1 = min(s, q0 + block)
        sc = torch.einsum("bqhgd,bkhd->bqhgk", qd[:, q0:q1], kd[:, :q1])
        mask = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        sc = torch.where(mask[None, :, None, None], sc, -torch.inf)
        out[:, q0:q1] = torch.einsum("bqhgk,bkhd->bqhgd",
                                     torch.softmax(sc, dim=-1), vd[:, :q1])
    return out


def off_alignment(x):
    """``x``'s values in a view whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape).copy_(x)
    assert view.data_ptr() % 16 == x.element_size()
    return view


def f32_flash_routes(what, moved, exactly=None):
    """The flash routes a float32 run's launches ``moved`` took: every
    ``flash_attention_causal`` launch on ``tf32x3`` (float32 with Dh % 8
    == 0, aligned), ``exactly`` of them where given, else at least one;
    raises otherwise."""
    n = moved.get("flash_attention_causal", 0)
    routes = {r: moved.get(f"flash_attention_causal/{r}", 0)
              for r in FLASH_ROUTES}
    count_ok = n >= 1 if exactly is None else n == exactly
    if not count_ok or routes != {"wgmma": 0, "tf32x3": n,
                                  "cuda_cores": 0}:
        want = "at least 1" if exactly is None else exactly
        raise AssertionError(f"{what}: float32 flash routes {routes} of {n} "
                             f"launches: expected tf32x3 only ({want})")
    return routes


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
            want = ("split_cluster" if name == "decode_attention" else
                    flash_route_wanted(dtype, shape[-1]))
            if variant != want:
                raise AssertionError(f"{name} {shape} {dtype}: launched "
                                     f"{variant}, expected {want}")
            ref = plain(*args)
            err = (out.float() - ref.float()).abs().max().item()
            tol = ATT_TOL[(name, dtype)]
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            # fewer timed calls at training length, as the backward's
            timing = dict(rounds=5, reps=2) if label == "training" else \
                dict(rounds=11, reps=10)
            f32_note = ""
            if name == "flash_attention_causal" and dtype == torch.float32:
                f32_note = flash_f32_extra(args, out, ref, variant, tol,
                                           timing)
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
            ms = _device_ms(kernel, args, **timing)
            plain_ms = _device_ms(plain, args, **timing)
            lib_ms = _device_ms(_sdpa, sdpa, **timing)
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
                f"call {host_ms * 1e3:.1f} us{f32_note}")
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
    flash_unaligned(device)
    return rows


def flash_f32_extra(args, out, ref, variant, tol, timing):
    """Phase 3's extra float32 flash checks: on the tf32x3 route, the
    CUDA-core kernel on the same inputs held against the plain version
    (same bits on a second call) and timed; every float32 output, and
    the plain version's, against a float64 softmax. Returns the log's
    note."""
    exact = attention_f64(*args)
    e64 = {"kernel": (out - exact).abs().max().item(),
           "plain": (ref - exact).abs().max().item()}
    note = ""
    if variant == "tf32x3":
        cc = flash_cuda_cores_f32(*args)
        torch.testing.assert_close(cc, ref, rtol=tol, atol=tol,
                                   msg=lambda m: f"cuda_cores: {m}")
        if not torch.equal(flash_cuda_cores_f32(*args), cc):
            raise AssertionError("flash cuda_cores float32: two calls on "
                                 "the same inputs differ")
        e64["cuda_cores"] = (cc - exact).abs().max().item()
        cc_ms = _device_ms(flash_cuda_cores_f32, args, **timing)
        note = (f"; cuda_cores kernel on the same inputs: max_abs_err "
                f"{(cc - ref).abs().max().item():.3g}, repeat bit-equal, "
                f"{cc_ms * 1e3:.2f} us")
    return note + (f"; max_abs_err against a float64 softmax "
                   f"{ {k: float(f'{x:.3g}') for k, x in e64.items()} }")


def flash_unaligned(device="cuda"):
    """Float32 q, k, v 4 bytes off 16-byte alignment: the wrapper sends
    them to the CUDA-core kernel, which agrees with the plain version and
    repeats its bits."""
    args, _, _, _ = _attention_case("flash_attention_causal",
                                    UNALIGNED_CASE, "odd", torch.float32,
                                    device)
    views = [off_alignment(x) for x in args]
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention_causal(*views)
    variant = _variant("flash_attention_causal", before)
    if variant != "cuda_cores":
        raise AssertionError(f"unaligned float32 flash launched {variant}, "
                             "expected cuda_cores")
    if not torch.equal(ops.flash_attention_causal(*views), out):
        raise AssertionError("unaligned float32 flash: two calls differ")
    ref = ops.flash_attention_causal_plain(*views)
    tol = ATT_TOL[("flash_attention_causal", torch.float32)]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    log(f"kernel flash_attention_causal unaligned {list(UNALIGNED_CASE)} "
        f"float32 (q, k, v 4 bytes off 16) [{variant}]: max_abs_err "
        f"{(out - ref).abs().max().item():.3g} (tol {tol}), repeat "
        f"bit-equal")


# ---------------------------------------------------------------------------
# flash_attention_causal's backward (B, S, KvH, G, Dh): the reference
# tests' shapes, odd ones, G = 1-7, Dh = 32-192 and the training path's
# shapes (phase 15: smollm-360m at B=8, S=2,048; deepseek-v2-lite's MLA
# at B=2, S=2,048, Dh = 192)
# ---------------------------------------------------------------------------
BWD_CASES = [((1, 128, 1, 1, 32), "tests"), ((2, 256, 2, 3, 64), "tests"),
             ((1, 512, 4, 2, 128), "tests"), ((2, 128, 2, 1, 64), "tests"),
             ((1, 300, 5, 3, 64), "odd"), ((2, 77, 2, 4, 40), "odd"),
             ((1, 257, 2, 7, 64), "odd"),
             # float32 Dh % 8 != 0: the CUDA-core kernels in both dtypes
             ((2, 77, 2, 4, 36), "odd"),
             # every tensor off 16-byte alignment: the CUDA-core kernels
             ((1, 300, 5, 3, 64), "unaligned"),
             ((2, 512, 5, 5, 64), "models"),           # hymba's globals
             ((2, 512, 8, 6, 128), "models"),          # grok, G = 6
             # llava's and mistral-nemo's heads
             ((2, 512, 8, 4, 128), "models"),
             ((2, 512, 8, 8, 128), "models"),          # qwen3, G = 8
             ((2, 512, 16, 1, 192), "models"),         # MLA, Dh = 192
             ((8, 2048, 5, 3, 64), "training"),
             ((2, 2048, 16, 1, 192), "training")] + \
    [(c, "training") for c in TRAIN_FAMILY_SHAPES]    # phase 15's families
TRAIN_SHAPE = (8, 2048, 5, 3, 64)
# relative to the plain backward's largest magnitude: float32 sums in
# another order (measured <= 5e-6 on an H100); bf16 adds one rounding of
# dq, dk, dv (measured <= 2.8e-3 on the CUDA cores) and, on the wgmma
# route, P and dS rounded to bf16 for the products (measured <= 6.9e-3)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def bwd_route_wanted(dtype, dh, aligned=True):
    """The backward route a call must take: with 16-byte aligned tensors
    and Dh <= 192, ``wgmma`` for bf16 with Dh % 16 == 0 and ``tf32x3``
    for float32 with Dh % 8 == 0; else ``cuda_cores``."""
    if aligned and dh <= flash_mod.BWD_WGMMA_MAX_DH:
        if dtype == torch.bfloat16 and dh % 16 == 0:
            return "wgmma"
        if dtype == torch.float32 and dh % 8 == 0:
            return "tf32x3"
    return "cuda_cores"


def bwd_cuda_cores_f32(q, k, v, out, dout):
    """One float32 backward on the three CUDA-core kernels through
    their own C functions, whatever route the wrapper would pick: phase 3
    holds and times them beside the tf32x3 kernels on the same inputs.
    Counts no launch (a comparison, not the path)."""
    b, s, kvh, g, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    dvec = torch.empty_like(lse)
    for kernel, args in (("stats", [q, k, out, dout, lse, dvec]),
                         ("dkdv", [q, k, v, dout, lse, dvec, dk, dv]),
                         ("dq", [q, k, v, dout, lse, dvec, dq])):
        _build.call("flash_attention_bwd",
                    f"flash_attention_causal_bwd_{kernel}_f32",
                    [ctypes.c_void_p] * len(args) + [ctypes.c_int] * 5
                    + [ctypes.c_float],
                    [x.data_ptr() for x in args]
                    + [b, s, kvh, g, dh, dh ** -0.5], q.device)
    return dq, dk, dv


def bwd_rel_errs(got, ref):
    """Each gradient's largest error relative to the plain gradient's
    largest magnitude (clamped at 1e-30: an exact 0 must be met exactly)."""
    return {name: float((a.float() - r.float()).abs().max()
                        / r.float().abs().max().clamp(min=1e-30))
            for name, a, r in zip(("dq", "dk", "dv"), got, ref)}


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
    one launch of each of its three kernels a call on the route that dtype,
    Dh and alignment pick (logged), timed beside the plain
    version, its bound and one SDPA backward; on the tf32x3 route the
    CUDA-core kernels held and timed on the same inputs too. Returns the
    kernels line's rows (the training shape: bf16, and float32 on
    tf32x3)."""
    rows = {}
    for shape, label in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _bwd_inputs(shape, dtype, device)
            if label == "unaligned":
                args = [off_alignment(x) for x in args]
            route = flash_mod.flash_bwd_route(*args)
            expect = bwd_route_wanted(dtype, shape[-1],
                                      aligned=label != "unaligned")
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
            errs = bwd_rel_errs(got, ref)
            tol = BWD_TOL[dtype]
            if max(errs.values()) > tol:
                raise AssertionError(f"backward {shape} {dtype}: relative "
                                     f"errors {errs} above {tol}")
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in zip(got, ref))
            big = label == "training"
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
            cc_note = ""
            if route == "tf32x3":
                cc_note = bwd_f32_cuda_cores(args, ref, tol, timing)
            log(f"kernel flash_attention_causal_bwd {label} {list(shape)} "
                f"{str(dtype)[6:]} ({route}): relative errors "
                f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol "
                f"{tol}), max_abs_err {err:.3g}, repeat bit-equal; device: "
                f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                f"sdpa backward {lib_ms * 1e3:.2f} us, bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} B, {flops} "
                f"flop), {100 * bound_ms / ms:.2f} % of bound{cc_note}")
            if shape == TRAIN_SHAPE:
                name = ("flash_attention_causal_bwd" if dtype == torch.bfloat16
                        else "flash_attention_causal_bwd/tf32x3")
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": ATT_SOURCE[name], "replaces": REPLACES[name],
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "shape": list(shape), "dtype": str(dtype)[6:],
                    "kernel_route": route, "relative_err": errs,
                    "bytes": nbytes, "flops": flops}
            del args, got, again, ref, sdpa
    torch.cuda.empty_cache()
    return rows


def bwd_f32_cuda_cores(args, ref, tol, timing):
    """Phase 3's extra check at a float32 backward case on tf32x3: the
    CUDA-core kernels on the same inputs held against the plain backward
    (same bits on a second call) and timed. Returns the log's note."""
    cc = bwd_cuda_cores_f32(*args)
    errs = bwd_rel_errs(cc, ref)
    if max(errs.values()) > tol:
        raise AssertionError(f"backward cuda_cores float32: relative errors "
                             f"{errs} above {tol}")
    if not all(torch.equal(a, b) for a, b in
               zip(bwd_cuda_cores_f32(*args), cc)):
        raise AssertionError("backward cuda_cores float32: two calls on the "
                             "same inputs differ")
    cc_ms = _device_ms(bwd_cuda_cores_f32, args, **timing)
    return (f"; cuda_cores kernels on the same inputs: relative errors "
            f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }, repeat "
            f"bit-equal, {cc_ms * 1e3:.2f} us")


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
    routes = f32_flash_routes("serving replay", {
        k: ops.LAUNCHES[k] - before[k] for k in before})
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
# whose 64 layers (~628 GB in bf16) need 8 cards; qwen3-32b's ~32.8 G
# parameters take ~61 GiB in bf16, so it runs last of the whole ones
MODEL_ARCHS = (("mamba2-370m", None), ("hymba-1.5b", None),
               ("seamless-m4t-large-v2", None),
               ("llava-next-mistral-7b", None),
               ("deepseek-v2-lite-16b", None),
               ("mistral-nemo-12b", None), ("nemotron-4-15b", None),
               ("qwen3-32b", None), ("grok-1-314b", 2))
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
        n_global = sum(i < cfg.num_layers for i in cfg.global_attn_layers)
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


def kernel_shapes(cfg):
    """The (name, shape) pairs of rows 4 and 5 that ``model_bf16`` gives
    the kernels, from ``cfg`` alone: flash q [B, S, KvH, G, Dh] of every
    causal unwindowed self-attention (llava's S is its patches and half
    the text; MLA's heads are 16 of G = 1 at Dh = nope + rope), and
    decode [B, KvH, G, Dh, T] over the MODEL_MAX_LEN self cache (hymba's
    windowed rings hold min(window, MODEL_MAX_LEN)) and, for enc-dec,
    the ENC_LEN_AT_DECODE cross cache."""
    n_flash, n_decode, _ = attention_layers(cfg)
    if cfg.attention == "mla":
        kvh, g = cfg.num_heads, 1
        dh = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    else:
        kvh = cfg.num_kv_heads
        g, dh = cfg.num_heads // max(kvh, 1), cfg.head_dim
    s = MODEL_S // 2 + cfg.num_patches if cfg.frontend == "patches" \
        else MODEL_S
    out = set()
    if n_flash:
        out.add(("flash_attention_causal", (MODEL_B, s, kvh, g, dh)))
    if n_decode:
        ts = {MODEL_MAX_LEN}
        if cfg.window:
            ts.add(min(cfg.window, MODEL_MAX_LEN))
        if cfg.enc_dec:
            ts.add(models_tf.ENC_LEN_AT_DECODE)
        out |= {("decode_attention", (MODEL_B, kvh, g, dh, t)) for t in ts}
    return out


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
    if on_card and held.shapes != kernel_shapes(cfg):
        raise AssertionError(f"{name}: kernel shapes {sorted(held.shapes)}"
                             f", from the config "
                             f"{sorted(kernel_shapes(cfg))}")
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
    # one launch a causal layer in the loss, the prefill and (but
    # enc-dec) the text-only prefill; decode launches no flash
    forwards = 2 if cfg.enc_dec else 3
    res = {"depth": depth, "launches": moved,
           "routes": f32_flash_routes(
               f"{name} replay", moved,
               exactly=attention_layers(cfg)[0] * forwards),
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
            f"(limit {REPLAY_TOL} of the largest magnitude); flash routes "
            f"{rep['routes']}; launches "
            f"{rep['launches']}, each shape against its plain version "
            f"(max_abs_err) {rep['held']} "
            f"({time.perf_counter() - t0:.1f} s)")
    return dict(total)


# ---------------------------------------------------------------------------
# the training path: smollm-360m at full width and depth (phase 15)
# ---------------------------------------------------------------------------
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SAVE_AT = "smollm-360m", 20, 10
# deepseek-v2-lite's bf16 step, which takes MLA's backward at Dh = 192:
# its first 2 of 27 layers (layer 0 dense, layer 1 MoE), B=2 x S=2,048,
# 5 steps, no save (its ~1.1 G parameters and their moments are ~11 GB)
MLA_ARCH, MLA_LAYERS, MLA_BATCH, MLA_STEPS = ("deepseek-v2-lite-16b", 2, 2,
                                              5)
# the float32 gradient replay: 2 layers of each family at full width, B=1
# and 32 tokens (256, one SSD chunk, with SSM heads; llava 32 patches +
# 32 tokens), MoE at a capacity that drops nothing
GRAD_ARCHS = ("smollm-360m", "hymba-1.5b", "seamless-m4t-large-v2",
              "llava-next-mistral-7b", "deepseek-v2-lite-16b",
              # SSD's backward with no attention; squared ReLU; qk-norm
              "mamba2-370m", "mistral-nemo-12b", "nemotron-4-15b",
              "qwen3-32b")
GRAD_TOKENS, GRAD_TOL = 32, 1e-3
# the bf16 steps of five more families: B=2, 2,048 text tokens (llava
# 1,024 beside its 2,304 patches; seamless 2,048 audio frames beside its
# 2,048 tokens), 4 steps, no save; each at its published widths, cut to
# the deepest stack whose TRAIN_BYTES_PER_PARAM (bf16 weight and
# gradient, float32 AdamW moments) stay within FAMILY_BUDGET_GIB, which
# leaves the rest of the card's 79.2 GiB to the activations and the
# update's float32 temporaries (grok-1-314b: one layer is 73 GiB)
FAMILY_ARCHS = ("seamless-m4t-large-v2", "llava-next-mistral-7b",
                "mistral-nemo-12b", "nemotron-4-15b", "qwen3-32b")
FAMILY_BATCH, FAMILY_SEQ, FAMILY_STEPS = 2, 2048, 4
FAMILY_TEXT = {"patches": 1024}          # text tokens beside the patches
TRAIN_BYTES_PER_PARAM, FAMILY_BUDGET_GIB = 12, 53
# the trainer's options in process: smollm-360m at full width, 2 layers,
# float32 with TF32 off, one batch of 8 x 512
OPTIONS_ARCH, OPTIONS_LAYERS, OPTIONS_BATCH, OPTIONS_SEQ = ("smollm-360m",
                                                            2, 8, 512)
OPTIONS_TOL = 1e-5
# the launchers as subprocesses (``python -m``), smollm-360m whole
LAUNCH_TRAIN = ("--arch", "smollm-360m", "--steps", "4", "--batch", "8",
                "--seq", "2048", "--microbatch", "2", "--compress-grads",
                "--log-every", "1")
LAUNCH_SERVE = ("--arch", "smollm-360m", "--requests", "8", "--prompt-len",
                "256", "--max-new", "16")
LAUNCH_TIMEOUT = 300


#: the HeldTraining instance open on this thread (thread ranks each hold
#: their own launches)
_HELD = threading.local()
_HELD_LOCK = threading.Lock()


def _held_fwd(fwd, q, k, v):
    out = fwd(q, k, v)
    held = getattr(_HELD, "held", None)
    if held is not None and q.is_cuda:
        held.shapes[tuple(q.shape)] += 1
        if held.armed:
            held.fwd = ([x.detach().clone() for x in (q, k, v)],
                        out.detach().clone())
    return out


def _all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tensors
               if x.is_floating_point())


def _held_bwd(bwd, *args):
    grads = bwd(*args)
    held = getattr(_HELD, "held", None)
    # the latest launch whose inputs are finite, else the first: where
    # SSD's overflow reaches a layer's upstream gradient, the plain
    # version spreads its NaN over the causal mask's zeros, which the
    # kernel skips, so only a finite launch can be held element by element
    if held is not None and held.armed and args[0].is_cuda and (
            held.bwd is None or _all_finite(args)):
        held.bwd = ([x.detach().clone() for x in args],
                    [x.detach().clone() for x in grads])
    return grads


class HeldTraining:
    """While open, keeps (detached copies of) the inputs and output of the
    latest flash forward and backward launch (the latest backward whose
    inputs are finite, ``_held_bwd``) of ``kernels.flash_attention``
    while ``armed`` (its operators' implementations,
    so a DTensor's local shards as the kernels see them), and counts the
    q shapes of every forward launch; ``check`` holds the kept launches
    against the plain versions on the same card tensors. Adds no launch
    but one backward where ``check`` must replace non-finite inputs.
    Records the launches of the thread that opened it, so the backward
    must run on that thread (``torch.autograd.
    set_multithreading_enabled(False)``). The first instance wraps the
    operators' implementations for good; the wrappers do nothing on a
    thread with no instance open."""

    def __enter__(self):
        self.armed, self.fwd, self.bwd = False, None, None
        #: the q shapes of the forward launches (a sharded step's are the
        #: rank's local shards)
        self.shapes = collections.Counter()
        with _HELD_LOCK:
            if getattr(flash_mod._forward, "func", None) is not _held_fwd:
                flash_mod._forward = functools.partial(_held_fwd,
                                                       flash_mod._forward)
                flash_mod._backward = functools.partial(_held_bwd,
                                                        flash_mod._backward)
        _HELD.held = self
        return self

    def __exit__(self, *exc):
        _HELD.held = None
        return False

    def check(self, what: str):
        """{"forward": err, "dq": ..., "dk": ..., "dv": ...}: the kept
        launches against the plain versions (phase 3's tolerances). Where
        every kept backward launch had non-finite inputs (SSD's overflow
        reaches each layer's upstream gradient at hymba's published
        width), the backward runs once more on the same shards with
        those elements drawn from a seeded normal (``"bwd_replaced"``:
        how many), held against the plain version on the same inputs; a
        caller counts its launches before this."""
        (q, k, v), out = self.fwd
        ref = ops.flash_attention_causal_plain(q, k, v)
        tol = ATT_TOL[("flash_attention_causal", q.dtype)]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{what}: {m}")
        errs = {"forward": float((out.float() - ref.float()).abs().max())}
        args, grads = self.bwd
        if not _all_finite(args):
            self.armed = False
            gen = torch.Generator(device=args[0].device).manual_seed(0)
            errs["bwd_replaced"] = sum(int((~torch.isfinite(x)).sum())
                                       for x in args)
            args = [torch.where(torch.isfinite(x), x, torch.randn(
                x.shape, generator=gen, device=x.device).to(x.dtype))
                for x in args]
            grads = flash_mod._backward(*args)
        for name, a, r in zip(("dq", "dk", "dv"), grads,
                              ops.flash_attention_causal_bwd_plain(*args)):
            rel = float((a.float() - r.float()).abs().max()
                        / r.float().abs().max().clamp(min=1e-30))
            if not rel <= BWD_TOL[args[0].dtype]:     # NaN fails too
                raise AssertionError(f"{what}: held backward {name} differs "
                                     f"by {rel:.3g} of its largest magnitude")
            errs[name] = rel
        return errs


#: phase 18's control replay on this thread: the ``embed`` lookup's
#: gradient summed in float64 (``f64_embed_grad``)
_F64_EMBED = threading.local()


class _F64Rows(torch.autograd.Function):
    """``row_gather(table, idx)`` whose table gradient is the float64 sum
    of the upstream gradient over the whole batch, cast once to the
    table's dtype: on DTensors the upstream gradient and the indices are
    gathered whole (their partial sums reduced) and every rank sums all
    of them, so a sharded run and an unsharded one sum the same terms in
    float64 (``index_put_`` with ``accumulate``)."""

    @staticmethod
    def forward(ctx, table, idx, gather):
        ctx.save_for_backward(idx)
        ctx.table = (tuple(table.shape), table.dtype,
                     getattr(table, "device_mesh", None),
                     tuple(getattr(table, "placements", ())))
        return gather(table, idx)       # grad off here: the same rows

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import distribute_tensor
        idx, = ctx.saved_tensors
        shape, dtype, mesh, placements = ctx.table
        if mesh is not None:
            grad, idx = grad.full_tensor(), idx.full_tensor()
        rows, dx = idx.reshape(-1).long(), grad.reshape(-1, shape[-1])
        g = torch.zeros(shape, dtype=torch.float64, device=dx.device)
        g = g.index_put_((rows,), dx.double(), accumulate=True).to(dtype)
        if mesh is not None:
            g = distribute_tensor(g, mesh, placements, src_data_rank=None)
        return g, None, None


def _f64_rows(gather, table, idx):
    if getattr(_F64_EMBED, "on", False) and table.requires_grad and \
            torch.is_grad_enabled():
        return _F64Rows.apply(table, idx, gather)
    return gather(table, idx)


@contextlib.contextmanager
def f64_embed_grad(on: bool = True):
    """While open on this thread (and ``on``), the models' ``embed``
    lookup (``transformer.row_gather``) takes ``_F64Rows``: its table
    gradient is summed in float64 over the whole batch. The first use
    wraps the lookup for good; the wrapper is the lookup itself on a
    thread with none open."""
    with _HELD_LOCK:
        if getattr(models_tf.row_gather, "func", None) is not _f64_rows:
            models_tf.row_gather = functools.partial(_f64_rows,
                                                     models_tf.row_gather)
    saved = getattr(_F64_EMBED, "on", False)
    _F64_EMBED.on = on
    try:
        yield
    finally:
        _F64_EMBED.on = saved


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


class FrontendBatches:
    """``SyntheticTokenSource``'s packed text batches with the config's
    frontend features beside them: [B, n_extra, feat] image patches (vlm)
    or audio frames (enc-dec) drawn from a seeded numpy generator, in the
    config's dtype, as ``model_batch`` lays them out (the reference's loss
    reads ``batch["patches"]`` / ``batch["frames"]``, which its token
    pipeline does not yield)."""

    def __init__(self, cfg, batch: int, seq: int, n_extra: int,
                 seed: int = 0):
        from repro_torch.data.pipeline import (PackedBatchIterator,
                                               SyntheticTokenSource)
        self.cfg, self.n_extra = cfg, n_extra
        self.text = PackedBatchIterator(
            SyntheticTokenSource(cfg.vocab_size, seed=seed), batch=batch,
            seq_len=seq)
        self.rng = np.random.default_rng(seed)
        self.feat = {"patches": models_tf.VISION_EMBED_DIM,
                     "frames": models_tf.AUDIO_FEAT_DIM}[cfg.frontend]

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self.text)
        x = self.rng.standard_normal(
            (item["tokens"].shape[0], self.n_extra, self.feat)).astype(
                np.float32)
        item[self.cfg.frontend] = torch.from_numpy(x).to(
            getattr(torch, self.cfg.dtype))
        return item

    def close(self):
        self.text.close()


def train_data(cfg, batch: int, seq: int, seed: int = 0):
    """The training batches of ``cfg``: [batch, seq] text from
    ``SyntheticTokenSource``; a vlm's ``cfg.num_patches`` patches or an
    enc-dec's ``seq`` audio frames beside it (``FrontendBatches``)."""
    from repro_torch.data.pipeline import (PackedBatchIterator,
                                           SyntheticTokenSource)
    if cfg.frontend == "patches":
        return FrontendBatches(cfg, batch, seq, cfg.num_patches, seed)
    if cfg.frontend == "frames":
        return FrontendBatches(cfg, batch, seq, seq, seed)
    return PackedBatchIterator(SyntheticTokenSource(cfg.vocab_size,
                                                    seed=seed),
                               batch=batch, seq_len=seq)


def train_steps(device="cuda", cfg=None, batch=8, seq=2048,
                steps=TRAIN_STEPS, save_at=TRAIN_SAVE_AT):
    """``Trainer`` (remat "full", AdamW) over ``train_data``: ``steps``
    steps with the launches and blockwise calls of each step counted from
    zero; at ``save_at`` (``None``: no save) a save through
    ``CheckpointManager``, a restore into a fresh ``Trainer`` (parameters
    and optimizer state bit-equal) and one step of both on one batch (the
    losses compared); the latest flash forward and backward launch held
    against the plain versions. Returns what phase 15 prints."""
    from repro_torch.training.train_loop import TrainConfig, Trainer
    cfg = cfg or get_config(TRAIN_ARCH)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    data = train_data(cfg, batch, seq)
    per_step = []

    def count(entry):
        per_step.append((dict(ops.LAUNCHES), dict(model_layers.BLOCKWISE)))
        ops.reset_launches()
        model_layers.reset_blockwise()

    losses, restore_s = [], 0.0
    # the backward on this thread: HeldTraining holds this thread's launches
    with torch.autograd.set_multithreading_enabled(False), \
            tempfile.TemporaryDirectory() as root, HeldTraining() as held:
        tcfg = TrainConfig(steps=steps, log_every=1,
                           checkpoint_dir=None if save_at is None else root,
                           checkpoint_every=save_at or steps)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, tcfg, data, device=device)
        _sync(device)
        init_s = time.perf_counter() - t0
        trainer.on_log = count
        ops.reset_launches()
        model_layers.reset_blockwise()
        if save_at is None:
            trainer.run(steps - 1)
        else:
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
        held_errs = held.check(f"{cfg.name} training") if on_card else {}
    data.close()
    hist = trainer.history
    n_params = sum(x.numel() for x in flatten(trainer.params).values())
    return {"cfg": cfg, "hist": hist, "per_step": per_step,
            "losses_after_restore": losses, "init_s": init_s,
            "restore_s": restore_s, "held": held_errs, "n_params": n_params,
            "shapes": dict(held.shapes),
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else 0.0)}


def mla_train_config():
    """deepseek-v2-lite-16b at its published widths, cut to MLA_LAYERS
    layers; bf16, remat "full", MoE at its capacity factor (1.25)."""
    return dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS,
                               dtype="bfloat16", remat="full")


def flash_forwards(cfg, n):
    """Forward calls of ``n`` attentions a layer in one loss and its
    gradient: under remat two a layer (the forward and the recompute) but
    one a dense prefix layer (the dense layers before the first MoE one
    run outside remat, as the reference's)."""
    if cfg.remat == "none":
        return n
    return 2 * n - (cfg.moe.first_moe_layer if cfg.moe else 0)


def train_step_launches(cfg):
    """(launches, blockwise flash calls) of one bf16 training step, from
    the config: ``flash_forwards`` launches of row 5 on the wgmma route
    for its causal unwindowed layers (``attention_layers``), one row 5b
    call (three kernels) a causal layer on the wgmma route; the blockwise
    calls those of its other attentions (seamless's encoder and
    cross-attention, hymba's windowed layers), each forward and
    recompute."""
    n_flash, _, n_blockwise = attention_layers(cfg)
    fwd = flash_forwards(cfg, n_flash)
    want = {"flash_attention_causal": fwd,
            "flash_attention_causal/wgmma": fwd,
            "flash_attention_causal_bwd": n_flash,
            "flash_attention_causal_bwd/wgmma": n_flash}
    want.update({f"flash_attention_causal_bwd/{k}": n_flash
                 for k in flash_mod.BWD_KERNELS})
    want = {k: v for k, v in want.items() if v}
    return want, (n_blockwise if cfg.remat == "none" else 2 * n_blockwise)


def check_train_launches(cfg, per_step, on_card=True):
    """Each step's launches and blockwise flash calls equal to
    ``train_step_launches(cfg)``."""
    want, n_blockwise = train_step_launches(cfg)
    for i, (launches, blockwise) in enumerate(per_step):
        got = {k: v for k, v in launches.items() if v}
        if on_card and got != want:
            raise AssertionError(f"{cfg.name} training step {i + 1}: "
                                 f"launches {got}, expected {want}")
        if on_card and blockwise["flash"] != n_blockwise:
            raise AssertionError(f"{cfg.name} training step {i + 1}: "
                                 f"blockwise calls {blockwise}, expected "
                                 f"{n_blockwise}")
    return want


def f32_flash_bwd_routes(what, moved, exactly):
    """The backward routes a float32 run's launches ``moved`` took:
    exactly ``exactly`` ``flash_attention_causal_bwd`` calls (one a
    causal layer), every one on ``tf32x3`` (float32 with Dh % 8 == 0,
    aligned), none on the CUDA cores; raises otherwise."""
    n = moved.get("flash_attention_causal_bwd", 0)
    routes = {r: moved.get(f"flash_attention_causal_bwd/{r}", 0)
              for r in FLASH_ROUTES}
    if n != exactly or routes != {"wgmma": 0, "tf32x3": n, "cuda_cores": 0}:
        raise AssertionError(f"{what}: float32 backward routes {routes} of "
                             f"{n} calls: expected tf32x3 only ({exactly})")
    return routes


def grad_flash_launches(cfg):
    """Forward flash launches of one ``value_and_grad`` (remat "full" in
    every GRAD_ARCHS config)."""
    return flash_forwards(cfg, attention_layers(cfg)[0])


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

    # the CPU side holds the parameters and their gradients (and a
    # float32 temporary of the largest leaf): stop where the host cannot
    need = 4 * (2 * n_params(cfg) + max(
        int(np.prod(d.shape)) for d in models_tf.param_defs(cfg).values()))
    if device != "cpu" and need / 2 ** 30 > host_free_gib():
        raise AssertionError(f"{name}: the host cannot hold the float32 "
                             f"replay's {need / 2 ** 30:.1f} GiB "
                             f"({host_free_gib():.1f} GiB available)")
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
    routes = {}
    if device != "cpu":
        routes = f32_flash_routes(f"{name} gradient replay", moved,
                                  exactly=grad_flash_launches(cfg))
        routes["backward"] = f32_flash_bwd_routes(
            f"{name} gradient replay", moved, attention_layers(cfg)[0])
    return {"launches": moved, "worst": worst, "loss": float(loss),
            "routes": routes, "need_gib": need / 2 ** 30,
            "cpu_loss": float(cpu_loss), "tokens": n,
            "nonfinite": nonfinite, "leaves": n_leaves,
            "seconds": {"card": card_s, "copy": copy_s, "cpu": cpu_s,
                        "compare": compare_s}}


def training_phase(device="cuda", before_launchers=None):
    """Phase 15 (see the module doc). Returns the launches of the bf16
    run's steps, its median step ms, the deepseek run's launches, the
    float32 gradient replays' backward calls (all on tf32x3) and the
    launches of the five families' bf16 steps. ``before_launchers`` is
    called after the timed and held parts, before the launchers'
    subprocesses (the smoke starts phase 19 there)."""
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
    del r
    torch.cuda.empty_cache()
    parts = {"smollm-360m": time.perf_counter() - t0}
    t1 = time.perf_counter()
    mla = mla_training(device)
    parts[MLA_ARCH] = time.perf_counter() - t1
    t1 = time.perf_counter()
    families = family_phase(device)
    parts["families"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    f32_bwd = 0
    for name in GRAD_ARCHS:
        t2 = time.perf_counter()
        g = grad_replay(name, device)
        f32_bwd += g["launches"].get("flash_attention_causal_bwd/tf32x3", 0)
        log(f"training replay {name}: float32, 2 layers, B=1, "
            f"{g['tokens']} tokens: loss card {g['loss']:.6f} cpu "
            f"{g['cpu_loss']:.6f}; worst gradient leaf {g['worst'][1]} at "
            f"{g['worst'][0]:.3g} of its largest magnitude (limit "
            f"{GRAD_TOL}); leaves with NaN on both devices at the same "
            f"places {len(g['nonfinite'])} of {g['leaves']} "
            f"{g['nonfinite']}; flash routes {g['routes']}; launches "
            f"{g['launches']}; host side {g['need_gib']:.1f} GiB "
            f"({time.perf_counter() - t2:.1f} s: "
            f"{ {k: round(v, 2) for k, v in g['seconds'].items()} })")
    parts["float32 replays"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    o = trainer_options(device)
    log(f"training options {OPTIONS_ARCH}: full width, {OPTIONS_LAYERS} "
        f"layers, float32 (TF32 off), one batch {OPTIONS_BATCH} x "
        f"{OPTIONS_SEQ}: make_train_step microbatch=2 against 0: loss "
        f"{o['metrics'][2]['loss']!r} / {o['metrics'][0]['loss']!r}, grad "
        f"norm {o['metrics'][2]['grad_norm']!r} / "
        f"{o['metrics'][0]['grad_norm']!r} (relative {o['rel']}; limit "
        f"{OPTIONS_TOL}); the two halves' gradient summed in float32 and "
        f"halved against the whole batch's: worst leaf {o['worst'][1]} at "
        f"{o['worst'][0]:.3g} of its largest magnitude (limit "
        f"{OPTIONS_TOL}); compress_grads(CompressionConfig()) of the card "
        f"gradient bit-equal to the cpu copy's in all {o['leaves']} leaves "
        f"({o['quantized']} quantized to int8)")
    del o
    torch.cuda.empty_cache()
    parts["options"] = time.perf_counter() - t1
    if before_launchers is not None:
        before_launchers()
    t1 = time.perf_counter()
    la = launchers_phase()
    log(f"launchers: train {la['train_s']:.1f} s (both runs), serve "
        f"{la['serve_s']:.1f} s; every printed loss finite; the build "
        f"directory unchanged; {nvidia_smi()}")
    parts["launchers"] = time.perf_counter() - t1
    log(f"training phase: {time.perf_counter() - t0:.1f} s "
        f"{ {k: round(v, 1) for k, v in parts.items()} }; {nvidia_smi()}")
    return dict(total), med, mla, f32_bwd, families


def mla_training(device="cuda"):
    """Phase 15's deepseek-v2-lite run (see the module doc). Returns its
    launches over the counted steps."""
    t0 = time.perf_counter()
    r = train_steps(device, cfg=mla_train_config(), batch=MLA_BATCH,
                    steps=MLA_STEPS, save_at=None)
    cfg, hist = r["cfg"], r["hist"]
    want = check_train_launches(cfg, r["per_step"])
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{MLA_ARCH} training losses {losses}")
    ms = [h["step_time_s"] * 1e3 for h in hist]
    med = statistics.median(ms[1:])
    total = collections.Counter()
    for launches, _ in r["per_step"]:
        total.update({k: v for k, v in launches.items() if v})
    log(f"training {MLA_ARCH}: full width, cut to {cfg.num_layers} of "
        f"{get_config(MLA_ARCH).num_layers} layers (layer 0 dense, d_ff "
        f"{cfg.moe.dense_d_ff}; layer 1 MoE, {cfg.moe.num_experts} experts "
        f"top-{cfg.moe.top_k} + {cfg.moe.num_shared} shared, capacity factor "
        f"{cfg.moe.capacity_factor}) and to {len(hist)} steps, no save; "
        f"bf16, remat {cfg.remat}, {r['n_params']:,} parameters (init "
        f"{r['init_s']:.2f} s); B={MLA_BATCH} S=2048 on "
        f"SyntheticTokenSource, AdamW; losses "
        f"{[round(x, 4) for x in losses]}; grad norms "
        f"{[round(h['grad_norm'], 3) for h in hist]}")
    tokens = hist[0]["tokens"]
    log(f"training {MLA_ARCH}: step ms {[round(x, 1) for x in ms]}; median "
        f"(steps 2-{len(hist)}) {med:.3f} ms = {tokens / med * 1e3:.1f} "
        f"tokens/s; max_memory_allocated {r['peak_gib']:.3f} GiB; launches "
        f"per step {want} in each of the {len(r['per_step'])} counted steps "
        f"(0 on flash_attention_causal_bwd/cuda_cores), 0 blockwise calls; "
        f"the latest forward and backward launch against the plain versions "
        f"{r['held']} ({time.perf_counter() - t0:.1f} s); {nvidia_smi()}")
    return dict(total)


def n_params(cfg) -> int:
    """Parameters of ``cfg`` (its schema, ``param_defs``)."""
    return sum(int(np.prod(d.shape))
               for d in models_tf.param_defs(cfg).values())


def family_config(name: str):
    """(cfg, GiB): ``name`` at its published widths in bf16, cut to the
    deepest stack whose TRAIN_BYTES_PER_PARAM bytes a parameter stay
    within FAMILY_BUDGET_GIB (whole where the whole model fits), and
    those GiB."""
    full = get_config(name)
    assert full.dtype == "bfloat16" and full.remat == "full", name
    for depth in range(full.num_layers, 0, -1):
        cfg = dataclasses.replace(full, num_layers=depth)
        gib = TRAIN_BYTES_PER_PARAM * n_params(cfg) / 2 ** 30
        if gib <= FAMILY_BUDGET_GIB:
            return cfg, gib
    raise AssertionError(f"{name}: one layer passes {FAMILY_BUDGET_GIB} GiB")


def family_text(cfg) -> int:
    """Text tokens a sequence of ``cfg``'s training batch."""
    return FAMILY_TEXT.get(cfg.frontend, FAMILY_SEQ)


def family_kernel_shape(cfg, batch=FAMILY_BATCH):
    """q [B, S, KvH, G, Dh] of rows 5 and 5b in ``cfg``'s training batch
    (llava's S: its patches and its text)."""
    s = family_text(cfg) + (cfg.num_patches if cfg.frontend == "patches"
                            else 0)
    kvh = cfg.num_kv_heads
    return (batch, s, kvh, cfg.num_heads // kvh, cfg.head_dim)


def family_training(name: str, device="cuda"):
    """One family's bf16 run (see the module doc): ``train_steps`` of
    FAMILY_STEPS steps, no save, at B=FAMILY_BATCH on ``family_config``;
    each step's launches held to the config's (``check_train_launches``),
    every forward launch at ``family_kernel_shape``. Returns what phase
    15 prints."""
    full_layers = get_config(name).num_layers
    cfg, gib = family_config(name)
    on_card = torch.device(device).type == "cuda"
    held_gib = torch.cuda.memory_allocated() / 2 ** 30 if on_card else 0.0
    r = train_steps(device, cfg=cfg, batch=FAMILY_BATCH,
                    seq=family_text(cfg), steps=FAMILY_STEPS, save_at=None)
    hist = r["hist"]
    want = check_train_launches(cfg, r["per_step"], on_card)
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name} training losses {losses}")
    shape = family_kernel_shape(cfg)
    if on_card and set(r["shapes"]) != {shape}:
        raise AssertionError(f"{name}: row 5 shapes {r['shapes']}, from "
                             f"the config {shape}")
    ms = [h["step_time_s"] * 1e3 for h in hist]
    med = statistics.median(ms[1:])
    positions = FAMILY_BATCH * shape[1]
    return {**r, "name": name, "want": want, "losses": losses, "ms": ms,
            "median_ms": med, "gib_12": gib, "full_layers": full_layers,
            "shape": shape, "tokens": hist[0]["tokens"],
            "positions": positions, "held_before_gib": held_gib,
            "blockwise": train_step_launches(cfg)[1]}


def log_family(f, smi):
    """Phase 15's lines of one family's run."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    cfg = f["cfg"]
    cut = (f"whole ({cfg.num_layers} layers"
           + (f" + {cfg.encoder_layers} encoder" if cfg.enc_dec else "")
           + ")" if cfg.num_layers == f["full_layers"] else
           f"cut to {cfg.num_layers} of {f['full_layers']} layers")
    extra = {"patches": f", {cfg.num_patches} patches beside the text",
             "frames": f", {family_text(cfg)} audio frames beside the "
                       "text"}.get(cfg.frontend, "")
    rate = f["tokens"] / f["median_ms"] * 1e3
    prate = f["positions"] / f["median_ms"] * 1e3
    share = 6 * f["n_params"] * prate / PEAK_FLOPS_BF16
    log(f"training {f['name']}: published widths, {cut}: "
        f"{f['n_params']:,} parameters, {TRAIN_BYTES_PER_PARAM} B each "
        f"= {f['gib_12']:.2f} GiB (bound {FAMILY_BUDGET_GIB}: the deepest "
        f"stack within it); bf16, remat {cfg.remat}, AdamW, init "
        f"{f['init_s']:.2f} s; B={FAMILY_BATCH}, {family_text(cfg)} text "
        f"tokens a sequence on SyntheticTokenSource{extra}, "
        f"{len(f['hist'])} steps, no save; losses "
        f"{[round(x, 4) for x in f['losses']]}; grad norms "
        f"{[round(h['grad_norm'], 3) for h in f['hist']]}")
    log(f"training {f['name']}: step ms {[round(x, 1) for x in f['ms']]}; "
        f"median (steps 2-{len(f['ms'])}) {f['median_ms']:.3f} ms = "
        f"{rate:.1f} text tokens/s, {prate:.1f} positions/s = "
        f"{100 * share:.2f} % of the bf16 peak (6 N positions / step "
        f"time); peak device memory {f['peak_gib']:.3f} GiB "
        f"({f['held_before_gib']:.3f} GiB held before the run); {smi}")
    log(f"training {f['name']}: launches per step {f['want']} in each of "
        f"the {len(f['per_step'])} counted steps (row 5 at "
        f"{list(f['shape'])}), {f['blockwise']} blockwise flash calls a "
        f"step; the latest forward and backward launch against the plain "
        f"versions {f['held']}")


def family_phase(device="cuda"):
    """Phase 15's bf16 runs of FAMILY_ARCHS, one at a time, each freed
    before the next. Returns their launches over the counted steps."""
    smi = nvidia_smi()
    total = collections.Counter()
    for name in FAMILY_ARCHS:
        t0 = time.perf_counter()
        f = family_training(name, device)
        for launches, _ in f["per_step"]:
            total.update({k: v for k, v in launches.items() if v})
        log_family(f, smi)
        del f
        torch.cuda.empty_cache()
        log(f"training {name}: {time.perf_counter() - t0:.1f} s")
    return dict(total)


def trainer_options(device="cuda", cfg=None, batch=OPTIONS_BATCH,
                    seq=OPTIONS_SEQ):
    """The trainer's options on one batch (see the module doc): one
    ``make_train_step`` with ``microbatch=2`` and one without, loss and
    grad norm within OPTIONS_TOL (relative); the two halves'
    ``value_and_grad`` summed in float32 and halved (as the step sums
    them) against the whole batch's, each leaf within OPTIONS_TOL of its
    largest magnitude; ``compress_grads`` of the whole batch's gradient
    bit-equal to the same call on its CPU copy. Float32 with TF32 off.
    Returns what phase 15 prints."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.compression import (CompressionConfig,
                                                  compress_grads)
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step,
                                                 value_and_grad)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or dataclasses.replace(get_config(OPTIONS_ARCH),
                                     num_layers=OPTIONS_LAYERS,
                                     dtype="float32")
    data = train_data(cfg, batch, seq, seed=5)
    one = {k: torch.as_tensor(v).to(device) for k, v in next(data).items()}
    data.close()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(5),
                         device)
    metrics = {}
    for mb in (2, 0):
        step = make_train_step(cfg, TrainConfig(microbatch=mb))
        _, _, m = step(params, opt.init_opt_state(params), one)
        metrics[mb] = {k: float(v) for k, v in m.items()}
    rel = {k: abs(metrics[2][k] - metrics[0][k]) / abs(metrics[0][k])
           for k in ("loss", "grad_norm")}
    if max(rel.values()) > OPTIONS_TOL:
        raise AssertionError(f"microbatch=2 against the whole batch: "
                             f"{metrics} ({rel})")
    _, whole = value_and_grad(params, one, cfg)
    whole = flatten(whole)
    half = batch // 2
    summed = {k: torch.zeros_like(v, dtype=torch.float32)
              for k, v in whole.items()}
    for i in range(2):
        part = {k: v[i * half:(i + 1) * half] for k, v in one.items()}
        for k, g in flatten(value_and_grad(params, part, cfg)[1]).items():
            summed[k] += g.float()
    worst = (0.0, "")
    for k, g in whole.items():
        err = float((summed[k] / 2 - g.float()).abs().max()
                    / g.float().abs().max().clamp(min=1e-30))
        worst = max(worst, (err, k))
    if worst[0] > OPTIONS_TOL:
        raise AssertionError(f"the microbatched gradient {worst[1]} differs "
                             f"from the whole batch's by {worst[0]:.3g}")
    ccfg = CompressionConfig()
    got = flatten(compress_grads(unflatten(whole), ccfg))
    want = flatten(compress_grads(unflatten(
        {k: v.cpu() for k, v in whole.items()}), ccfg))
    quantized = sum(v.numel() >= ccfg.min_size for v in whole.values())
    _same_state({k: v.cpu() for k, v in got.items()}, want,
                "compressed gradient, card against cpu")
    return {"cfg": cfg, "metrics": metrics, "rel": rel, "worst": worst,
            "leaves": len(whole), "quantized": quantized}


def run_launcher(module: str, args, timeout=LAUNCH_TIMEOUT) -> str:
    """``python -m module args`` from the repo's root with this
    process's ``PYTHONPATH`` in front of the repo's ``src`` (so it loads
    the kernels this process built, from the same build directory);
    raises unless it exits 0. Returns its standard output."""
    root = Path(__file__).resolve().parent
    path = [str(root / "src"), str(root)]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                         env=dict(os.environ,
                                  PYTHONPATH=os.pathsep.join(path)),
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)} exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    return out.stdout


def step_losses(text: str, what: str):
    """The losses of a launcher's step lines, each finite."""
    losses = [float(x) for x in re.findall(r"^step \d+: loss=(\S+)", text,
                                           re.M)]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: step losses {losses}")
    return losses


def launchers_phase():
    """Both launchers as subprocesses on the card (see the module doc):
    train, then resume from its checkpoint; serve. Forwards their step
    and served lines; the build directory must hold the same libraries
    after them (they built nothing)."""
    built = sorted(p.name for p in _build.BUILD_ROOT.iterdir())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        first = run_launcher("repro_torch.launch.train",
                             LAUNCH_TRAIN + ("--ckpt", ckpt))
        second = run_launcher("repro_torch.launch.train",
                              LAUNCH_TRAIN + ("--ckpt", ckpt, "--resume"))
    train_s = time.perf_counter() - t0
    for what, text in (("train", first), ("train --resume", second)):
        for line in text.splitlines():
            log(f"launcher {what}: {line}")
    a, b = (step_losses(x, "train launcher") for x in (first, second))
    steps = int(LAUNCH_TRAIN[LAUNCH_TRAIN.index("--steps") + 1])
    if f"resumed from step {steps}" not in second.splitlines() or \
            len(a) != steps or len(b) != steps:
        raise AssertionError(f"train launcher: {len(a)} then {len(b)} "
                             f"steps; the second run did not resume from "
                             f"step {steps}")
    t0 = time.perf_counter()
    served = run_launcher("repro_torch.launch.serve", LAUNCH_SERVE)
    serve_s = time.perf_counter() - t0
    line = next((x for x in served.splitlines()
                 if x.startswith("served ")), "")
    log(f"launcher serve: {line}")
    if not line.startswith("served 8 requests / 128 tokens"):
        raise AssertionError(f"serve launcher printed {served!r}")
    after = sorted(p.name for p in _build.BUILD_ROOT.iterdir())
    if after != built:
        raise AssertionError(f"the launchers built {set(after) - set(built)}")
    return {"train_s": train_s, "serve_s": serve_s, "losses": a + b}


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


#: phase 16's production-mesh cells: (arch, shapes, mesh), each shape in a
#: process of its own, both at once
PRODUCTION_CELLS = ("mistral-nemo-12b", ("decode_32k", "prefill_32k"),
                    "single")
PRODUCTION_KERNEL = {"decode_32k": "repro_torch::decode_attention",
                     "prefill_32k": "repro_torch::flash_attention_causal"}


def dryrun_production(arch=PRODUCTION_CELLS[0], shapes=PRODUCTION_CELLS[1],
                      mesh=PRODUCTION_CELLS[2], timeout=600):
    """``python -m repro_torch.launch.dryrun --arch <arch> --shape <s>
    --mesh <mesh>`` for each shape, at published widths on fake tensors
    on the card, each in a process of its own, all started together.
    Each cell must be ``ok``, its ``memory.argument_bytes`` must equal
    rank 0's bytes reckoned from the config and the sharding specs
    (``launch.specs.argument_bytes``, no step run) and its attention must
    reach the kernel's operator (``PRODUCTION_KERNEL``, counted by
    formula), once a layer. Returns {shape: (record, reckoned bytes,
    seconds)}."""
    from repro_torch.launch import specs
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               REPRO_SEQUENCE_PARALLEL="0")
    cfg = get_config(arch)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for shape in shapes:
            path = Path(tmp) / f"{shape}.json"
            procs[shape] = (path, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", str(path)], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        try:
            for shape, (path, t0, proc) in procs.items():
                _, err = proc.communicate(timeout=timeout)
                secs = time.perf_counter() - t0
                if proc.returncode != 0 or not path.exists():
                    raise AssertionError(f"dry run {arch} {shape} {mesh} "
                                         f"exited {proc.returncode}: "
                                         f"{err[-2000:]}")
                out[shape] = (json.loads(path.read_text())[
                    f"{arch}|{shape}|{mesh}"], secs)
        finally:
            for _, _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for shape, (rec, secs) in out.items():
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} {shape} {mesh}: {rec}")
        want = specs.argument_bytes(cfg, shape, MESHES[mesh])
        if rec["memory"]["argument_bytes"] != want["total"]:
            raise AssertionError(
                f"dry run {arch} {shape} {mesh}: argument bytes "
                f"{rec['memory']['argument_bytes']} != reckoned {want}")
        op = PRODUCTION_KERNEL[shape]
        if rec["kernels"].get(op) != cfg.num_layers:
            raise AssertionError(f"dry run {arch} {shape} {mesh}: kernel "
                                 f"calls {rec['kernels']}, want {op} "
                                 f"x {cfg.num_layers}")
        out[shape] = (rec, want, secs)
    return out


def roofline_phase(step_ms: float, device="cuda"):
    """Phase 16 (see the module doc)."""
    from repro_torch.launch import roofline
    smi = nvidia_smi()
    t0 = time.perf_counter()
    # the production cells' processes (host work, fake tensors) run beside
    # the phase's own steps; their results are held at the phase's end
    pool = ThreadPoolExecutor(1)
    production = pool.submit(dryrun_production)
    try:
        _roofline_checks(step_ms, device, roofline, smi)
        cells = production.result()
    finally:
        pool.shutdown(wait=True)
    arch, _, mesh = PRODUCTION_CELLS
    for shape, (rec, want, secs) in cells.items():
        mem = rec["memory"]
        row = roofline.analyze_cell(f"{arch}|{shape}|{mesh}", rec)
        log(f"dry run {arch}|{shape}|{mesh} ({rec['devices']} cards, "
            f"published widths, fake tensors on the card): ok in "
            f"{secs:.1f} s (run {rec['compile_s']} s); argument bytes "
            f"{mem['argument_bytes']} == reckoned {want}; peak per device "
            f"{mem['peak_bytes_per_device'] / 2 ** 30:.3f} GiB; kernels "
            f"{rec['kernels']}; dot flops {rec['jaxpr']['dot_flops']:.6g};"
            f" collective bytes {rec['collectives']['total_bytes']:.6g}; "
            f"roofline row: {roofline.fmt_row(row)}")
    log(f"production-mesh cells: {len(cells)} run together beside the "
        f"phase's other work; {smi}")
    log(f"roofline phase: {time.perf_counter() - t0:.1f} s; {nvidia_smi()}")


def _roofline_checks(step_ms, device, roofline, smi):
    """Phase 16's step counts, one-rank DTensor step and local dry run
    (``roofline_phase``)."""
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


# ---------------------------------------------------------------------------
# phase 17: the mesh= substrate
# ---------------------------------------------------------------------------
MESH_RANKS, MESH_BATCHES, MESH_PIN_AFTER, MESH_READS = 4, 5, 2, 1024
MESH_TIMEOUT = 300
#: adaptive K: batches after the pin's release, each followed by a
#: ``gc_sweep`` (the policy's hysteresis donates a record only once it
#: was idle at two sweeps), as ``tests/test_torch_mesh_engine.py`` runs
MESH_POLICY_BATCHES = 3
MESH_NAMES = ("mvcc_resolve/rows", "mvcc_resolve/windows",
              "mvcc_resolve_masked/rows", "mvcc_resolve_masked/windows",
              "mvcc_resolve_paged/rows", "mvcc_resolve_paged/windows")


def mesh_substrates(n: int, R: int = YCSB_HIGH_10RMW.num_records) -> dict:
    """Phase 17's storage settings over ``n`` shards: the engine's dense
    defaults; the paged path's own (``PAGED``, phase 6's, with its 2M
    pages a shard: 160 MB of slab a shard, memory that does not force a
    change); and the adaptive-K settings of
    ``tests/test_torch_mesh_engine.py`` (``ADAPTIVE``: 64 records over 4
    shards, 4 pages and one 16-slot spill bucket a record of a shard)
    scaled to ``R`` records (the paged slab too, below 1M records: a
    CPU rehearsal)."""
    per_shard = -(-R // n)
    full = YCSB_HIGH_10RMW.num_records
    return {"dense": {},
            "paged": dict(PAGED, pages_per_shard=PAGED["pages_per_shard"]
                          * R // full),
            "adaptive": dict(ring_slots=4, adaptive_k=True, k_max=8,
                             paged=True, page_slots=2,
                             pages_per_shard=4 * per_shard,
                             spill_buckets=per_shard, spill_slots=16)}


def mesh_stream(mesh, n: int, device="cuda", seed=0, R=None, kw=None,
                T=None):
    """Phase 17's stream on ``BohmEngine(mesh=mesh, **kw)`` (``None``:
    the logical engine of ``n`` shards): 5 batches, a pin after batch 2,
    a pinned ``snapshot_read`` of 1,024 zipfian records, one
    ``gc_sweep``; with adaptive K the pin is then released and
    MESH_POLICY_BATCHES batches each end in a sweep. On a mesh every
    rank runs it; the primary's row (1, or 3 on a page slab) and row 2
    are then held against their plain versions on the rank's own shard
    and page table, and every rank's launches (its own thread's), the
    slots the policy granted its records and its batch ms gather to
    all. ``R`` records and ``T`` transactions a batch default to
    YCSB_HIGH_10RMW's. Returns host copies (the store only on rank 0 of
    a mesh)."""
    from repro_torch.store.sharded import all_gather, full_store, local_store
    cfg = YCSB_HIGH_10RMW
    R, T = R or cfg.num_records, T or cfg.batch_size
    rng = np.random.default_rng(seed)
    eng = BohmEngine(R, make_ycsb(cfg.payload_words), mesh=mesh,
                     n_shards=n, device=device, **(kw or {}))
    start = dict(_build.thread_launches())
    out = {"reads": [], "batch_ms": [], "gc": []}

    def batch():
        b = gen_ycsb_batch(rng, T, R, theta=cfg.theta,
                           mix=cfg.mix, device=device)
        _sync(device)
        t0 = time.perf_counter()
        reads, _ = eng.run_batch(b)
        _sync(device)
        out["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        out["reads"].append(reads.cpu().numpy())

    for i in range(MESH_BATCHES):
        batch()
        if i + 1 == MESH_PIN_AFTER:
            pin = eng.begin_snapshot()
    records = gen_ycsb_batch(np.random.default_rng(seed + 1), MESH_READS,
                             R, theta=cfg.theta, ops=1,
                             device=device).read_set[:, 0].contiguous()
    vals, found = eng.snapshot_read(records, pin)
    out.update(vals=vals.cpu().numpy(), found=found.cpu().numpy())
    out["gc"].append(eng.gc_sweep())
    if eng.adaptive_k:
        eng.release_snapshot(pin)
        for _ in range(MESH_POLICY_BATCHES):
            batch()
            out["gc"].append(eng.gc_sweep())
    launches = {k: v - start.get(k, 0)
                for k, v in _build.thread_launches().items()}
    out["launches"] = launches
    out["stats"] = {"storage": eng.storage_stats(),
                    "spill": eng.spill_stats(),
                    "counters": {k: v for k, v in eng.metrics.snapshot(
                        include_gauges=False).items()
                        if k.startswith("engine/") and np.ndim(v) == 0}}
    out["k_by_record"] = eng.k_by_record().cpu().numpy()
    rank0 = mesh is None or mesh.get_local_rank() == 0
    versions = full_store(eng.store.versions)
    if rank0:
        out["store"] = store_to_numpy(dataclasses.replace(
            eng.store, versions=versions))
    if mesh is None:
        return out
    # the primary's row and row 2 on this rank's own shard, beside their
    # plain versions
    s, loc = mesh.get_local_rank(), local_store(eng.store.versions)
    local = torch.div(records, n, rounding_mode="floor")
    rows = local.clamp(0, loc.records_per_shard - 1).contiguous()
    ts = torch.full_like(rows, pin.ts)
    if loc.pages is not None:
        pg = loc.pages
        args = (pg.page_table[0], pg.begin[0], pg.end[0], pg.payload[0], ts)
        k = ops.mvcc_resolve_paged(*args, rows=rows)
        p = ops.mvcc_resolve_paged_plain(*args, rows)
    else:
        ring = loc.rings
        args = (ring.begin[0], ring.end[0], ring.payload[0], ts)
        k = ops.mvcc_resolve(*args, rows=rows)
        p = ops.mvcc_resolve_plain(*args, rows)
    pool = loc.spill
    pool_args = (pool.begin[0], pool.end[0], pool.rec[0], local,
                 pool.payload[0], ts)
    km = ops.mvcc_resolve_masked(*pool_args, in_place=True, prior=k)
    pm = ops.mvcc_resolve_masked_plain(*pool_args, in_place=True, prior=p)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              ((k[0], p[0]), (km[0], pm[0])))
    same = all(torch.equal(a, b) for a, b in zip(k + km, p + pm))
    granted = int((loc.k_eff[0].long() - eng.ring_slots).clamp(min=0).sum())
    held = 3 if loc.pages is not None else 1          # the primary's row
    mine = torch.tensor([launches.get(x, 0) for x in MESH_NAMES] + [
        err, int(same), s, granted, held], device=vals.device)
    out["ranks"] = all_gather(mine, mesh).tolist()
    out["rank_batch_ms"] = all_gather(torch.tensor(
        out["batch_ms"], dtype=torch.float64, device=vals.device),
        mesh).tolist()
    return out if rank0 else None


def thread_ranks(fn, n: int, timeout: float = MESH_TIMEOUT,
                 device="cuda", mesh=None):
    """``fn(mesh)`` on n ranks that are threads of this process, over
    torch's threaded process group on the card (as
    ``torch.testing._internal.common_distributed`` opens it); the ranks'
    results in rank order. The mesh is the one-dim ``cc`` mesh, or
    ``launch.mesh.device_mesh(*mesh)`` for ``mesh = (shape, axis
    names)`` (``spawn_ranks``' arguments). Each rank runs its autograd
    backward on its own thread (``set_multithreading_enabled(False)``:
    one device thread shared by every rank could block in one rank's
    collective while holding the others' nodes), so a rank's launches,
    backward included, are its thread's. A rank that raises stops the
    others' collectives and the call raises; so does a rank still
    running after ``timeout`` seconds. The port's CPU mesh tests run
    their ranks here too (``device="cpu"``)."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg, _uninstall_threaded_pg)

    from repro_torch.launch.mesh import cc_mesh, device_mesh
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    ProcessLocalGroup.reset()
    store = dist.HashStore()
    results, errors = [None] * n, [None] * n

    def rank(r):
        try:
            dist.init_process_group("threaded", rank=r, world_size=n,
                                    store=store,
                                    timeout=timedelta(seconds=timeout))
            with torch.autograd.set_multithreading_enabled(False):
                results[r] = fn(cc_mesh(device) if mesh is None
                                else device_mesh(*mesh, device))
            _sync(device)
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors[r] = exc
            ProcessLocalGroup.exception_handle(exc)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(n)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, t in enumerate(threads) if t.is_alive()]
        if hung:
            ProcessLocalGroup.exception_handle(TimeoutError())
            raise TimeoutError(f"mesh ranks {hung} still ran after "
                               f"{timeout} s")
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    real = [e for e in errors if e is not None
            and not isinstance(e, SystemExit)]
    if real or any(e is not None for e in errors):
        raise (real or [e for e in errors if e is not None])[0]
    return results


def _same_mesh_run(want: dict, got: dict, what: str) -> None:
    """A mesh run against the logical engine's, byte for byte."""
    for i, (a, b) in enumerate(zip(want["reads"], got["reads"])):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} batch {i} "
                                                    f"reads")
    for key in ("vals", "found", "k_by_record"):
        np.testing.assert_array_equal(want[key], got[key],
                                      err_msg=f"{what} {key}")
    for key in ("gc", "stats"):
        if want[key] != got[key]:
            raise AssertionError(f"{what} {key}: {got[key]}, logical "
                                 f"{want[key]}")
    if sorted(want["store"]) != sorted(got["store"]):
        raise AssertionError(f"{what} store arrays {sorted(got['store'])}")
    for name in want["store"]:
        np.testing.assert_array_equal(want["store"][name],
                                      got["store"][name],
                                      err_msg=f"{what} store {name}")


def mesh_checks(got: dict, kw: dict, what: str, on_card=True) -> list:
    """Every rank of a mesh run held the primary's row (row 3 on a page
    slab, else row 1) and row 2 bit for bit against their plain versions
    on its own shard, had slots granted to its records where K is
    adaptive, and on the card launched both rows in place only (none of
    the other primary's, no windows form). Returns the per-rank rows by
    name."""
    paged = bool(kw.get("paged"))
    primary = "mvcc_resolve_paged" if paged else "mvcc_resolve"
    other = "mvcc_resolve" if paged else "mvcc_resolve_paged"
    per = []
    for r, row in enumerate(got["ranks"]):
        x = dict(zip(MESH_NAMES, row[:len(MESH_NAMES)]))
        x.update(zip(("err", "same", "rank", "granted", "held"),
                     row[len(MESH_NAMES):]))
        if on_card and (
                x[f"{primary}/rows"] <= 0 or x["mvcc_resolve_masked/rows"]
                <= 0 or x[f"{other}/rows"] or any(
                    x[f"{k}/windows"] for k in ("mvcc_resolve",
                                                "mvcc_resolve_masked",
                                                "mvcc_resolve_paged"))):
            raise AssertionError(f"{what} mesh rank {r} launches {x}")
        if x["held"] != (3 if paged else 1) or x["err"] != 0 or \
                x["same"] != 1 or x["rank"] != r:
            raise AssertionError(f"{what} mesh rank {r}: {primary} and "
                                 f"mvcc_resolve_masked differ from their "
                                 f"plain versions on its shard ({x})")
        if kw.get("adaptive_k") and x["granted"] <= 0:
            raise AssertionError(f"{what} mesh rank {r}: the adaptive-K "
                                 f"policy granted its records no slots")
        per.append(x)
    return per


def mesh_phase(device="cuda"):
    """Phase 17: the mesh engine against the logical engine of the same
    shards, byte for byte, on each of ``mesh_substrates``; returns the
    launches of the mesh runs' paths, summed over their ranks (the held
    comparisons' launches left out)."""
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    n = min(MESH_RANKS, cards) if cards >= 2 else MESH_RANKS
    if cards >= 2:
        from benchmarks_torch.common import spawn_ranks
        substrate = f"{n} processes, one a card, over NCCL"
    else:
        substrate = f"{n} thread ranks over the threaded process group " \
            f"on one card"
    R = YCSB_HIGH_10RMW.num_records
    path = collections.Counter()
    for what, kw in mesh_substrates(n, R).items():
        fn = functools.partial(mesh_stream, n=n, device=device, kw=kw)
        ops.reset_launches()        # each rank also counts its own from 0
        t0 = time.perf_counter()
        got = (spawn_ranks(fn, n, device, timeout=MESH_TIMEOUT)[0]
               if cards >= 2 else thread_ranks(fn, n)[0])
        mesh_s = time.perf_counter() - t0
        per = mesh_checks(got, kw, what)
        t0 = time.perf_counter()
        want = mesh_stream(None, n, device, kw=kw)
        logical_s = time.perf_counter() - t0
        _same_mesh_run(want, got, what)
        for x in per:
            for name in ("mvcc_resolve", "mvcc_resolve_masked",
                         "mvcc_resolve_paged"):
                path[name] += x[f"{name}/rows"]
        st = got["stats"]
        log(f"mesh path {what} ({kw or 'the dense defaults'}): substrate "
            f"{substrate}; {R:,} records, {len(got['batch_ms'])} batches "
            f"of {YCSB_HIGH_10RMW.batch_size}, a pinned read of "
            f"{MESH_READS} (found {float(got['found'].mean()):.4f}), "
            f"gc_sweep reclaimed {got['gc']}: reads, found, pinned values, "
            f"k_by_record, storage / spill stats, engine counters and all "
            f"{len(want['store'])} store arrays ({sorted(want['store'])}) "
            f"byte-equal to the logical {n}-shard engine; storage "
            f"{st['storage']}; counters {st['counters']}")
        launched = [{k: v for k, v in x.items() if k in MESH_NAMES and v}
                    for x in per]
        log(f"mesh path {what}: per-rank launches {launched}"
            f"; the primary's row and row 2 held against their plain "
            f"versions on every rank's shard, max abs err "
            f"{max(x['err'] for x in per)}; slots granted to each rank's "
            f"records {[x['granted'] for x in per]}")
        log(f"mesh path {what}: batch ms per rank "
            f"{[[round(t, 3) for t in r] for r in got['rank_batch_ms']]}, "
            f"logical {[round(x, 3) for x in want['batch_ms']]}; median "
            f"batch mesh (rank 0) {statistics.median(got['batch_ms']):.3f} "
            f"ms vs logical {statistics.median(want['batch_ms']):.3f} ms; "
            f"mesh run {mesh_s:.1f} s, logical {logical_s:.1f} s; "
            f"{nvidia_smi()}")
        del got, want
        torch.cuda.empty_cache()
    log(f"mesh path: phase {time.perf_counter() - t_phase:.1f} s; "
        f"{nvidia_smi()}")
    return dict(path)


# ---------------------------------------------------------------------------
# phase 18: the elastic restart
# ---------------------------------------------------------------------------
#: the first world's mesh; the restart's is ``plan_remesh``'s for 2 ranks
ELASTIC_MESH = ((2, 2), ("data", "model"))
ELASTIC_RANKS, ELASTIC_SURVIVORS = 4, 2
ELASTIC_STEPS = (3, 2)          # the first world's steps, then the restart's
ELASTIC_TIMEOUT = 600
#: sharded against unsharded: phase 15's float32 limit (worst leaf)
ELASTIC_TOL = GRAD_TOL
#: parameters past ELASTIC_TOL after AdamW steps: at most this share of a
#: leaf's elements, each within ADAM_REACH x lr x steps (twice the 0.31
#: measured on the H100; AdamW's own cap is 2 x 1.17 = 2.34: |m^| /
#: sqrt(v^) <= 1.17 at b1 0.9, b2 0.95, and two runs may step opposite
#: ways)
ADAM_FLIPS, ADAM_REACH = 1e-5, 0.62
#: step 1's gradient of each run (sharded and not, with and without the
#: control's float64 lookup) against its float64 recomputation on the
#: CPU (``embed_arbiter``): the worst leaf (measured <= 3.98e-6 on the
#: H100) and the ``embed`` elements of another sign, at most ADAM_FLIPS
#: of its nonzero ones (measured 1-2 of 1,106,880)
ARBITER_TOL = 1e-5


#: the control replay's case names: the float32 case's, then this
CONTROL = "_f64embed"
#: the bf16 case's depth: 4 of smollm-360m's 32 layers, which keeps the
#: whole smoke inside its time limit with the GQA-split case and phase
#: 19 beside phases 16-18
ELASTIC_BF16_LAYERS = 4


def gqa_split_config():
    """Phase 18's GQA-split case: reduced smollm-360m (2 layers, d_model
    64, Dh 16) in float32 with 6 query and 3 KV heads, so ``model`` = 2
    shards the query heads but not the KV heads and the flash kernels'
    group split (``layers.split_groups``) gathers the heads first."""
    from repro_torch.configs import reduced_config
    return dataclasses.replace(reduced_config(TRAIN_ARCH), dtype="float32",
                               num_heads=6, num_kv_heads=3)


def elastic_cases(reduced=None, control=True):
    """Phase 18's configurations (see the module doc): smollm-360m at
    ELASTIC_BF16_LAYERS of its 32 layers in bf16 (B=8, S=2,048; its 15 /
    5 heads do not divide ``model`` = 2, so the flash kernels run on
    batch shards), the same at 2 layers in
    float32 (B=4, S=512), reduced smollm-360m in float32 (B=4, S=256; 4
    / 2 heads, so they run on head shards too) and the GQA-split case
    (``gqa_split_config``: 6 / 3 heads, B=4, S=256; the query heads
    shard over ``model`` and are gathered before the group split, so the
    kernels run on batch shards with every KV head). ``reduced``
    replaces the configurations (a CPU rehearsal). Each: name, config,
    batch, sequence, seed of the weights and of the data, whether it is
    held against an unsharded run (float32), its starting parameters
    (None: seeded) and whether its ``embed`` gradient is summed in
    float64 (``f64_embed_grad``). With ``control`` each held case comes
    again as the control replay (its name + CONTROL), its lookup's
    gradient summed in float64 in the sharded and the unsharded run."""
    from repro_torch.configs import reduced_config
    full = get_config(TRAIN_ARCH)
    cases = reduced or [
        ("bf16", dataclasses.replace(full, dtype="bfloat16", remat="full",
                                     num_layers=ELASTIC_BF16_LAYERS), 8, 2048),
        ("f32_2layers", dataclasses.replace(full, num_layers=2,
                                            dtype="float32"), 4, 512),
        ("f32_reduced", dataclasses.replace(reduced_config(TRAIN_ARCH),
                                            dtype="float32"), 4, 256),
        ("f32_gqa_split", gqa_split_config(), 4, 256)]
    out = [dict(name=n, cfg=c, batch=b, seq=s, seed=18, data_seed=3,
                held=c.dtype == "float32", params=None, f64_embed=False)
           for n, c, b, s in cases]
    # the control replay: each float32 case again with the embed table's
    # gradient summed in float64 in both runs (``f64_embed_grad``)
    return out + [dict(c, name=c["name"] + CONTROL, f64_embed=True)
                  for c in out if c["held"] and control]


def _elastic_data(case, skip: int):
    """The case's batches after the first ``skip`` (every rank draws the
    same global batches)."""
    from repro_torch.data.pipeline import (PackedBatchIterator,
                                           SyntheticTokenSource)
    data = PackedBatchIterator(
        SyntheticTokenSource(case["cfg"].vocab_size, seed=case["data_seed"]),
        batch=case["batch"], seq_len=case["seq"])
    for _ in range(skip):
        next(data)
    return data


def _elastic_params(case, device):
    """The case's starting parameters: the given numpy tree through
    ``params_from_reference``, else seeded on ``device``."""
    if case["params"] is not None:
        return models_tf.params_from_reference(case["params"], case["cfg"],
                                               device)
    return init_params(case["cfg"], torch.Generator(
        device=device).manual_seed(case["seed"]), device)


def elastic_shardings(cfg, mesh):
    """The ``restore(shardings=)`` tree of a training state on ``mesh``:
    ``param_shardings`` and ``opt_state_shardings`` paired with it."""
    from repro_torch.parallel import sharding as shd
    psh = shd.param_shardings(cfg, mesh)
    return shd.named_shardings(mesh, {
        "params": psh,
        "opt": shd.opt_state_shardings(psh, {"step": None}, mesh)})


def restored_equals_files(state, shardings, vdir: Path) -> int:
    """Every restored leaf is a DTensor placed as its sharding says, and
    gathered (every rank takes part) equals its file bit for bit (checked
    on global rank 0). Returns the leaves checked; raises otherwise."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import _to_host
    meta = json.loads((vdir / "MANIFEST.json").read_text())
    flat, flat_sh = flatten(state), flatten(shardings)
    if sorted(flat) != meta["leaves"]:
        raise AssertionError("restored leaves differ from the manifest")
    for name, x in flat.items():
        if not isinstance(x, DTensor) or \
                tuple(x.placements) != flat_sh[name].placements:
            raise AssertionError(f"restored {name}: {type(x).__name__} "
                                 f"{getattr(x, 'placements', None)}")
        arr, dtype = _to_host(x)            # gathered, as a save gathers
        if dist.get_rank() == 0:
            want = np.load(vdir / (name.replace("/", "__") + ".npy"))
            if dtype != meta["dtypes"][name] or want.dtype != arr.dtype \
                    or not np.array_equal(want, arr):
                raise AssertionError(f"restored {name} differs from its "
                                     f"file")
    return len(flat)


def _elastic_case(mesh, case, root: str, first: bool, device):
    """One case of one world on this rank (see ``elastic_world``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.constraints import activation_mesh
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step,
                                                 value_and_grad)
    cfg, on_card = case["cfg"], torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = CheckpointManager(str(Path(root) / case["name"]))
    rec = {"rank": dist.get_rank(), "restore_s": 0.0, "restored": 0}
    t0 = time.perf_counter()
    if first:
        specs = flatten(shd.param_shardings(cfg, mesh))
        params = unflatten({
            k: distribute_tensor(v, mesh, shd.placements(specs[k], mesh),
                                 src_data_rank=None)
            for k, v in flatten(_elastic_params(case, device)).items()})
        opt = init_opt_state(params)
        start = 0
    else:
        sh = elastic_shardings(cfg, mesh)
        start, state, _ = ckpt.restore(shardings=sh)
        _sync(device)
        rec["restore_s"] = time.perf_counter() - t0
        rec["restored"] = restored_equals_files(
            state, sh, ckpt.dir / f"step_{start:012d}")
        params, opt = state["params"], state["opt"]
        del state
    rec["start"], rec["setup_s"] = start, time.perf_counter() - t0
    n = ELASTIC_STEPS[0 if first else 1]
    data = _elastic_data(case, start)
    batches = [{k: distribute_tensor(
        torch.as_tensor(v).to(device), mesh, shd.placements(
            shd.batch_sharding(mesh, v.shape), mesh), src_data_rank=None)
        for k, v in next(data).items()} for _ in range(n)]
    data.close()
    step_fn = make_train_step(cfg, TrainConfig())
    losses, norms, ms = [], [], []
    # the backward on this rank's thread: its launches are this thread's
    with activation_mesh(mesh), implicit_replication(), \
            torch.autograd.set_multithreading_enabled(False):
        if case["held"]:        # the gradient at the world's start, saved
            _, grads = value_and_grad(params, batches[0], cfg)
            CheckpointManager(str(Path(root) / f"{case['name']}_grads"),
                              async_save=False).save(start, grads)
            del grads
        before = dict(_build.thread_launches())
        with HeldTraining() as held:
            for i, batch in enumerate(batches):
                held.armed = on_card and i == n - 1
                _sync(device)
                t1 = time.perf_counter()
                params, opt, m = step_fn(params, opt, batch)
                losses.append(float(m["loss"].full_tensor()))
                ms.append((time.perf_counter() - t1) * 1e3)
                norms.append(float(m["grad_norm"].full_tensor()))
            rec["held"] = held.check(f"{case['name']} rank "
                                     f"{rec['rank']}") if on_card else {}
            rec["shapes"] = dict(held.shapes)
    rec["launches"] = {k: v - before.get(k, 0)
                       for k, v in _build.thread_launches().items()
                       if v != before.get(k, 0)}
    rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                       if on_card else 0.0)
    rec.update(losses=losses, grad_norms=norms, step_ms=ms)
    t1 = time.perf_counter()
    if first or case["held"]:
        ckpt.save(start + n, {"params": params, "opt": opt})
        ckpt.wait()
    rec["save_s"] = time.perf_counter() - t1
    return rec


def elastic_world(mesh, cases, root: str, first: bool, device="cuda"):
    """One world of phase 18 on each rank of ``mesh``, case by case. The
    first world places each case's weights by ``param_shardings`` (every
    rank makes the same; none is sent), takes ELASTIC_STEPS[0] AdamW
    steps under ``activation_mesh`` and ``implicit_replication`` and
    saves through ``CheckpointManager`` (every rank gathers, rank 0
    writes); the restart restores with ``shardings=`` onto its mesh,
    holds the restored state (gathered) to the files bit for bit, and
    takes ELASTIC_STEPS[1] steps (saving them where the case is held
    against an unsharded run). The last step's flash forward and
    backward launches are held against the plain versions on the card.
    Returns this rank's record per case."""
    out = {}
    for case in cases:
        with f64_embed_grad(case["f64_embed"]):
            out[case["name"]] = _elastic_case(mesh, case, root, first,
                                              device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def unsharded_steps(case, device):
    """The case's ``sum(ELASTIC_STEPS)`` steps on plain tensors on one
    device: the losses, and for a held case the parameters after each
    world's last step and each element's gradient at the first step that
    gave it a nonzero one (``value_and_grad`` at that step's parameters
    and batch; 0 where none did), numpy by leaf name."""
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step,
                                                 value_and_grad)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = case["cfg"]
    params = _elastic_params(case, device)
    opt = init_opt_state(params)
    step_fn = make_train_step(cfg, TrainConfig())
    data = _elastic_data(case, 0)
    losses, after, first = [], {}, None
    for i in range(sum(ELASTIC_STEPS)):
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in next(data).items()}
        if case["held"]:
            grads = flatten(value_and_grad(params, batch, cfg)[1])
            if first is None:
                first = {k: torch.zeros_like(g) for k, g in grads.items()}
            for k, g in grads.items():
                first[k] = torch.where(first[k] == 0, g, first[k])
            del grads
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if case["held"] and i + 1 in (ELASTIC_STEPS[0], sum(ELASTIC_STEPS)):
            after[i + 1] = {k: v.float().cpu().numpy()
                            for k, v in flatten(params).items()}
    data.close()
    return {"losses": losses, "params": after,
            "first_grads": {k: v.float().cpu().numpy()
                            for k, v in (first or {}).items()}}


def worst_leaf(got: dict, want: dict):
    """(largest |got - want| / max |want| over the leaves, its leaf)."""
    worst = (0.0, "")
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        rel = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        worst = max(worst, (rel, k))
    return worst


def param_agreement(got: dict, want: dict, steps: int, first_grads: dict,
                    gap: dict, tol: float = None) -> dict:
    """Parameters of a sharded run against the unsharded run's after
    ``steps`` AdamW steps. AdamW's first update of an element is ~lr x
    sign(gradient) whatever the gradient's size, so where a gradient
    sits at the two runs' difference the runs step opposite ways.
    Returns the worst leaf (largest |got - want| over the leaf's largest
    magnitude), per leaf the elements past ``tol`` (with the leaf's
    size) and the largest difference of them in units of lr x steps; and
    a second reading: the elements whose unsharded gradient at their
    first nonzero update (``first_grads``) lies below the leaf's gap
    between sharded and unsharded gradients at equal parameters
    (``gap``, absolute), per leaf how many and how many of them are past
    ``tol``, and the worst leaf over every other element."""
    from repro_torch.training.optimizer import AdamWConfig
    tol = ELASTIC_TOL if tol is None else tol
    unit = AdamWConfig().lr * steps
    worst, held, beyond, noisy, reach = (0.0, ""), (0.0, ""), {}, {}, 0.0
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - w)
        top = max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, (float(d.max()) / top, k))
        past = d > tol * top
        if past.any():
            beyond[k] = (int(past.sum()), w.size)
            reach = max(reach, float(d.max()) / unit)
        g = np.abs(first_grads[k])
        noise = (g > 0) & (g <= gap[k])
        held = max(held, (float(d[~noise].max(initial=0.0)) / top, k))
        if noise.any():
            noisy[k] = (int(noise.sum()), int((past & noise).sum()))
    return {"worst": worst, "beyond": beyond, "reach": reach,
            "below_gap": noisy, "worst_above_gap": held}


def start_gradients(case, root: str, device):
    """Each world's gradient at its start (saved by the world from its
    DTensors, gathered) against ``value_and_grad`` on plain tensors at the
    same parameters (the seeded ones; the first world's checkpoint) and
    batch: [(start step, worst leaf)], and per leaf the largest
    |sharded - unsharded| over both starts."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.training.train_loop import value_and_grad
    out, gap = [], {}
    for start in (0, ELASTIC_STEPS[0]):
        if start == 0:
            params = _elastic_params(case, device)
        else:
            params = CheckpointManager(str(Path(root) / case["name"])
                                       ).restore(start, device=device)[1][
                                           "params"]
        data = _elastic_data(case, start)
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in next(data).items()}
        data.close()
        _, grads = value_and_grad(params, batch, case["cfg"])
        want = {k: v.float().cpu().numpy() for k, v in flatten(grads).items()}
        del params, grads
        got = {k: v.float().numpy() for k, v in flatten(
            CheckpointManager(str(Path(root) / f"{case['name']}_grads")
                              ).restore(start, device="cpu")[1]).items()}
        out.append((start, worst_leaf(got, want)))
        for k, w in want.items():
            gap[k] = max(gap.get(k, 0.0), float(np.abs(
                got[k].astype(np.float64) - w).max()))
    return out, gap


@contextlib.contextmanager
def float64_math():
    """While open, ``Tensor.float()`` leaves a float64 tensor as it is
    and new tensors default to float64: a model whose parameters are
    float64 then keeps its norms' statistics, its products, its softmax
    and its logits in float64, where the port computes them in float32
    (rope's angles stay float32, the same in every run). For the
    arbiter's recomputation only, on one thread: it patches the class."""
    orig, dtype = torch.Tensor.float, torch.get_default_dtype()

    def keep64(self, *args, **kw):
        return self if self.dtype == torch.float64 else orig(self, *args,
                                                             **kw)
    torch.Tensor.float = keep64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig
        torch.set_default_dtype(dtype)


#: ``embed_arbiter``'s runs
RUNS = ("unsharded", "unsharded_f64", "sharded", "sharded_f64")


def embed_arbiter(case, root: str, base: str, device) -> dict:
    """Step 1's gradient of four runs against a float64 recomputation on
    the CPU (``value_and_grad`` of the same model in float64 under
    ``float64_math``, at the seeded parameters and the first batch):
    the unsharded run on this process's device by default and with the
    lookup's float64 sum (``f64_embed_grad``), and the first world's
    saved start gradient of the default case (``base``) and of the
    control. Each: the ``embed`` leaf's largest difference over the
    recomputation's largest magnitude, its elements of another sign
    than the recomputation's (of those where it is nonzero), and the
    worst leaf of the whole gradient."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.training.train_loop import value_and_grad
    cfg = case["cfg"]
    data = _elastic_data(case, 0)
    host = next(data)
    data.close()
    params = _elastic_params(case, device)
    batch = {k: torch.as_tensor(v).to(device) for k, v in host.items()}
    runs = {}
    for key, on in (("unsharded", False), ("unsharded_f64", True)):
        with f64_embed_grad(on):
            runs[key] = {k: v.float().cpu().numpy() for k, v in flatten(
                value_and_grad(params, batch, cfg)[1]).items()}
    p64 = unflatten({k: v.detach().cpu().double()
                     for k, v in flatten(params).items()})
    del params, batch
    for key, name in (("sharded", base), ("sharded_f64", case["name"])):
        runs[key] = {k: v.float().numpy() for k, v in flatten(
            CheckpointManager(str(Path(root) / f"{name}_grads")).restore(
                0, device="cpu")[1]).items()}
    with float64_math():
        ref = {k: v.numpy() for k, v in flatten(value_and_grad(
            p64, {k: torch.as_tensor(v) for k, v in host.items()},
            dataclasses.replace(cfg, dtype="float64"))[1]).items()}
    del p64
    e = ref["embed"]
    top = max(float(np.abs(e).max()), 1e-30)
    nz = e != 0
    out = {"nonzero": int(nz.sum())}
    for key, g in runs.items():
        d = np.abs(g["embed"].astype(np.float64) - e)
        out[key] = {"rel": float(d.max()) / top,
                    "sign": int((np.sign(g["embed"][nz]) != np.sign(e[nz])
                                 ).sum()),
                    "worst_leaf": worst_leaf(g, ref)}
    return out


def check_arbiter(name: str, a: dict) -> None:
    """Raises unless every run of ``embed_arbiter``'s result sits within
    float32 rounding of the float64 recomputation: its worst leaf within
    ARBITER_TOL of each leaf's largest magnitude, and at most ADAM_FLIPS
    of ``embed``'s nonzero elements of another sign. A run with a wrong
    gradient (a sharded sum that drops or doubles a term) fails here,
    whatever the other run does."""
    for run in RUNS:
        worst, leaf = a[run]["worst_leaf"]
        if worst > ARBITER_TOL or a[run]["rel"] > ARBITER_TOL or \
                a[run]["sign"] > ADAM_FLIPS * a["nonzero"]:
            raise AssertionError(
                f"{name}: the {run} run's step-1 gradient departs from its "
                f"float64 recomputation: {a[run]} (worst leaf {leaf}; "
                f"limits {ARBITER_TOL}, {ADAM_FLIPS} of {a['nonzero']} "
                f"embed elements of another sign)")


def saved_params(root: str, name: str, step: int) -> dict:
    """A case's saved parameters at ``step`` (numpy float32, by leaf)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    _, state, _ = CheckpointManager(str(Path(root) / name)).restore(
        step, device="cpu")
    return {k: v.float().numpy() for k, v in flatten(state["params"]).items()}


def elastic_launcher(n: int, device="cuda"):
    """(launch, substrate) for a world of n ranks: one process a card over
    NCCL where the cards suffice (``spawn_ranks``), else n thread ranks
    sharing card 0 (``thread_ranks``); on the CPU, processes over gloo.
    Both take ``(fn, n, device, timeout=, mesh=)``."""
    from benchmarks_torch.common import spawn_ranks
    on_card = torch.device(device).type == "cuda"
    if not on_card:
        return spawn_ranks, f"{n} processes over gloo"
    if torch.cuda.device_count() >= n:
        return spawn_ranks, f"{n} processes over nccl, one a card"

    def threads(fn, n, device, timeout, mesh):
        return thread_ranks(fn, n, timeout, device, mesh=mesh)
    return threads, (f"{n} thread ranks over the threaded process group "
                     f"on one card")


def elastic_restart(cases, device="cuda", timeout=None, root=None):
    """Both worlds of phase 18 (the first on ELASTIC_MESH, the restart on
    ``plan_remesh``'s mesh for ELASTIC_SURVIVORS ranks), each launched by
    ``elastic_launcher``; each case's unsharded run on this process's
    device first (a bf16 run's losses printed beside, not held: bf16
    rounds each order differently). Returns the plan, each world's
    substrate, ranks' records and peak GiB (the launching process's,
    where the ranks are its threads), the unsharded runs, each held
    case's comparison and the seconds each part took. The checkpoints go
    to a temporary directory, or to ``root`` where they stay."""
    from repro_torch.ft.monitor import plan_remesh
    timeout = timeout or ELASTIC_TIMEOUT
    on_card = torch.device(device).type == "cuda"
    plan = plan_remesh(ELASTIC_SURVIVORS, model_parallel=2)
    worlds = (("first", ELASTIC_RANKS, ELASTIC_MESH),
              ("second", plan.devices,
               ((plan.data, plan.model), ELASTIC_MESH[1])))
    secs, want, out = {}, {}, {"plan": plan}
    t0 = time.perf_counter()
    for case in cases:
        with f64_embed_grad(case["f64_embed"]):
            want[case["name"]] = unsharded_steps(case, device)
        if on_card:
            torch.cuda.empty_cache()
    secs["unsharded"] = time.perf_counter() - t0
    with (contextlib.nullcontext(root) if root
          else tempfile.TemporaryDirectory()) as root:
        for name, n, mesh in worlds:
            launch, out[f"{name}_substrate"] = elastic_launcher(n, device)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out[name] = launch(functools.partial(
                elastic_world, cases=cases, root=root,
                first=name == "first", device=device), n, device,
                timeout=timeout, mesh=mesh)
            secs[name] = time.perf_counter() - t0
            out[f"{name}_mesh"] = mesh[0]
            out[f"{name}_process_peak_gib"] = (
                torch.cuda.max_memory_allocated() / 2 ** 30
                if on_card else 0.0)
        held = {}
        for case in cases:
            name, w = case["name"], want[case["name"]]
            if not case["held"]:
                continue
            losses = out["first"][0][name]["losses"] + \
                out["second"][0][name]["losses"]
            with f64_embed_grad(case["f64_embed"]):
                grads, gap = start_gradients(case, root, device)
            held[name] = {
                "losses": losses,
                "loss_rel": max(abs(a - b) / abs(b) for a, b in
                                zip(losses, w["losses"])),
                "grads": grads,
                "params": [param_agreement(saved_params(root, name, s),
                                           w["params"][s], s,
                                           w["first_grads"], gap)
                           for s in sorted(w["params"])]}
        for case in cases:
            if case["f64_embed"]:
                base = case["name"][:-len(CONTROL)]
                held[case["name"]]["arbiter"] = embed_arbiter(
                    case, root, base, device)
    out.update(want=want, held=held, seconds=secs)
    return out


def elastic_checks(cases, r, on_card=True):
    """Phase 18's checks on ``elastic_restart``'s result: every rank of
    each world took its steps with one loss list per world, launched
    rows 5 and 5b exactly as many times as its layers and steps need,
    all on the tensor-core route of the case's dtype (never the CUDA
    cores), on local shards of the expected shape (KV heads split where
    they divide ``model``); the restart restored every leaf bit-equal;
    the held cases' losses and saved parameters within ELASTIC_TOL of
    the unsharded run (but for isolated AdamW sign flips), and every
    run's step-1 gradient within float32 rounding of its float64
    recomputation (``check_arbiter``). Returns the launches summed over
    every rank of both worlds."""
    total = collections.Counter()
    for world, mesh in (("first", r["first_mesh"]),
                        ("second", r["second_mesh"])):
        steps = ELASTIC_STEPS[0 if world == "first" else 1]
        for case in cases:
            cfg, name = case["cfg"], case["name"]
            recs = [rank[name] for rank in r[world]]
            if len({tuple(x["losses"]) for x in recs}) != 1 or \
                    not all(np.isfinite(recs[0]["losses"])):
                raise AssertionError(f"{name} {world}: losses "
                                     f"{[x['losses'] for x in recs]}")
            if world == "second" and any(
                    x["restored"] != recs[0]["restored"] or not x[
                        "restored"] for x in recs):
                raise AssertionError(f"{name}: restored leaves "
                                     f"{[x['restored'] for x in recs]}")
            route = "wgmma" if cfg.dtype == "bfloat16" else "tf32x3"
            layers = attention_layers(cfg)[0]
            want = {"flash_attention_causal": steps * grad_flash_launches(
                        cfg),
                    "flash_attention_causal_bwd": steps * layers}
            for op in list(want):
                want[f"{op}/{route}"] = want[op]
            want.update({f"flash_attention_causal_bwd/{k}": steps * layers
                         for k in flash_mod.BWD_KERNELS})
            kvh = cfg.num_kv_heads
            tp = mesh[1] if kvh % mesh[1] == 0 else 1
            local = (case["batch"] // mesh[0], case["seq"], kvh // tp,
                     cfg.num_heads // kvh, cfg.head_dim)
            for x in recs:
                if on_card and x["launches"] != want:
                    raise AssertionError(f"{name} {world} rank {x['rank']}"
                                         f": launches {x['launches']}, "
                                         f"expected {want}")
                if on_card and set(x["shapes"]) != {local}:
                    raise AssertionError(f"{name} {world} rank {x['rank']}"
                                         f": local q shapes {x['shapes']}"
                                         f", expected {local}")
                total.update(x["launches"])
    for name, h in r["held"].items():
        if "arbiter" in h:
            check_arbiter(name, h["arbiter"])
        grads = max(w for _, w in h["grads"])
        if h["loss_rel"] > ELASTIC_TOL or grads[0] > ELASTIC_TOL:
            raise AssertionError(f"{name}: sharded against unsharded loss "
                                 f"{h['loss_rel']:.3g}, gradients at each "
                                 f"world's start {h['grads']}; limit "
                                 f"{ELASTIC_TOL}")
        for p in h["params"]:
            flips = all(n <= ADAM_FLIPS * size
                        for n, size in p["beyond"].values())
            if not flips or p["reach"] > ADAM_REACH:
                raise AssertionError(f"{name}: parameters {p}: past "
                                     f"{ELASTIC_TOL} beyond isolated AdamW "
                                     f"sign flips")
    return dict(total)


def elastic_phase(device="cuda"):
    """Phase 18 (see the module doc). Returns rows 5 and 5b's launches,
    summed over every rank of both worlds."""
    t0 = time.perf_counter()
    cases = elastic_cases()
    r = elastic_restart(cases, device)
    total = elastic_checks(cases, r,
                           on_card=torch.device(device).type == "cuda")
    smi = nvidia_smi()
    plan = r["plan"]
    log(f"elastic restart: first world {r['first_substrate']} on a "
        f"{r['first_mesh']} (data, model) mesh, {ELASTIC_STEPS[0]} steps, "
        f"a save; plan_remesh({ELASTIC_SURVIVORS}, model_parallel=2) = "
        f"(data {plan.data}, model {plan.model}): restart "
        f"{r['second_substrate']} on {r['second_mesh']}, restore with "
        f"shardings=, {ELASTIC_STEPS[1]} steps; {smi}")
    for case in cases:
        name, cfg = case["name"], case["cfg"]
        for world in ("first", "second"):
            recs = [rank[name] for rank in r[world]]
            x = recs[0]
            ms = [[round(t, 1) for t in y["step_ms"]] for y in recs]
            if world == "first" and not case["held"]:
                log(f"elastic {name}: the same {sum(ELASTIC_STEPS)} steps "
                    f"unsharded on one card: losses "
                    f"{[round(v, 6) for v in r['want'][name]['losses']]} "
                    f"(not held: bf16 rounds each order differently)")
            log(f"elastic {name} ({cfg.num_layers} layers, d_model "
                f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} "
                f"heads, Dh {cfg.head_dim}, {cfg.dtype}, remat "
                f"{cfg.remat}, B={case['batch']} S={case['seq']}) {world} "
                f"world on {r[world + '_mesh']}: losses "
                f"{[round(v, 6) for v in x['losses']]}, grad norms "
                f"{[round(v, 4) for v in x['grad_norms']]}; step ms per "
                f"rank {ms}; peak GiB per rank "
                f"{[round(y['peak_gib'], 3) for y in recs]} (the launching "
                f"process {r[world + '_process_peak_gib']:.3f}); launches "
                f"per rank {x['launches']}; local q shapes {x['shapes']}; "
                f"held launches (rank 0) {x['held']}; setup "
                f"{x['setup_s']:.2f} s (restore {x['restore_s']:.2f} s, "
                f"{x['restored']} leaves bit-equal to the files), save "
                f"{x['save_s']:.2f} s; {smi}")
    for name, h in r["held"].items():
        got = [round(v, 6) for v in h["losses"]]
        want = [round(v, 6) for v in r["want"][name]["losses"]]
        log(f"elastic {name}: sharded losses {got} against unsharded on "
            f"one card {want}: worst {h['loss_rel']:.3g}; gradient at "
            f"each world's start (step, worst leaf) {h['grads']} (limit "
            f"{ELASTIC_TOL}); saved parameters after steps "
            f"{ELASTIC_STEPS[0]} and {sum(ELASTIC_STEPS)}: "
            f"{h['params']} (worst leaf; per leaf the elements past "
            f"{ELASTIC_TOL} of its largest magnitude and its size; the "
            f"largest of them in lr x steps; per leaf the elements whose "
            f"gradient at their first nonzero update lies below the "
            f"leaf's start-gradient gap and those of them past "
            f"{ELASTIC_TOL}; the worst leaf over the other elements)")
        if "arbiter" in h:
            log(f"elastic {name}: step 1's gradient against its float64 "
                f"recomputation on the cpu: {h['arbiter']} (per run: the "
                f"embed leaf's largest difference over its largest "
                f"magnitude, its elements of another sign among the "
                f"nonzero ones; the worst leaf)")
    log(f"elastic restart: launches over both worlds' ranks {total}; "
        f"seconds { {k: round(v, 1) for k, v in r['seconds'].items()} }; "
        f"phase {time.perf_counter() - t0:.1f} s; {smi}")
    return total


#: the flash operators on a DTensor's local shards: q's shape
SHARD_FLASH = {torch.float32: (4, 128, 2, 3, 16),
               torch.bfloat16: (4, 256, 2, 3, 64)}


def flash_on_shards(mesh, device="cuda", dtype=torch.float32):
    """The flash operators' forward and backward on DTensors of ``mesh``
    sharded on the batch (over its first mesh dim of size > 1), on the KV
    heads (over its last) and, on two such dims, on both; each rank runs
    the kernels (the plain versions on the CPU) on its local shards. The
    gathered output and gradients are held against the plain versions on
    the whole tensors. Returns {case: {"forward": max abs err, "dq" /
    "dk" / "dv": max abs err over the largest magnitude, "local": the
    local q shape}} and this rank's launches (its thread's: the backward
    runs there)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    big = [i for i, n in enumerate(tuple(mesh.shape)) if n > 1]
    cases = {"batch": {big[0]: Shard(0)}, "heads": {big[-1]: Shard(2)}}
    if len(big) > 1:
        cases["batch+heads"] = {big[0]: Shard(0), big[-1]: Shard(2)}
    b, s, kvh, g, dh = SHARD_FLASH[dtype]
    rng = np.random.default_rng(11)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(device=device, dtype=dtype)

    q, dout = draw(b, s, kvh, g, dh), draw(b, s, kvh, g, dh)
    k, v = draw(b, s, kvh, dh), draw(b, s, kvh, dh)
    ref = ops.flash_attention_causal_plain(q, k, v)
    ref_grads = ops.flash_attention_causal_bwd_plain(q, k, v, ref, dout)
    before = dict(_build.thread_launches())
    out_errs = {}
    for name, dims in cases.items():
        pl = [dims.get(i, Replicate()) for i in range(mesh.ndim)]
        leaves = [distribute_tensor(x, mesh, pl, src_data_rank=None
                                    ).requires_grad_(True)
                  for x in (q, k, v)]
        out = ops.flash_attention_causal(*leaves)
        if tuple(out.placements) != tuple(pl):
            raise AssertionError(f"flash on {name} shards: output placed "
                                 f"{out.placements}, inputs {pl}")
        with torch.autograd.set_multithreading_enabled(False):
            out.backward(distribute_tensor(dout, mesh, pl,
                                           src_data_rank=None))
        errs = {"forward": float((out.detach().full_tensor().float()
                                  - ref.float()).abs().max()),
                "local": tuple(leaves[0].to_local().shape)}
        for gname, x, r in zip(("dq", "dk", "dv"), leaves, ref_grads):
            errs[gname] = float((x.grad.full_tensor().float() - r.float())
                                .abs().max() / r.float().abs().max())
        out_errs[name] = errs
    launches = {k: n - before.get(k, 0)
                for k, n in _build.thread_launches().items()
                if n != before.get(k, 0)}
    return out_errs, launches


# ---------------------------------------------------------------------------
# phase 19: the sharded families
# ---------------------------------------------------------------------------
#: the nine families beside phase 18's smollm-360m
SHARDED_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b", "hymba-1.5b",
                 "llava-next-mistral-7b", "mamba2-370m", "mistral-nemo-12b",
                 "nemotron-4-15b", "qwen3-32b", "seamless-m4t-large-v2")
SHARDED_MOE = ("deepseek-v2-lite-16b", "grok-1-314b")
#: the worlds: (2, 2) with sequence parallelism off and on, (2, 2, 1) for
#: the MoE families (the batch over two mesh dims), (1, 2) at published
#: widths
SHARDED_MESHES = {"2x2": ((2, 2), ("data", "model")),
                  "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
                  "1x2": ((1, 2), ("data", "model"))}
#: reduced width: B x S (S even for sequence parallelism; llava's 16
#: patches within it, seamless's frames as long) and the AdamW steps
SHARDED_BATCH, SHARDED_SEQ, SHARDED_STEPS = 4, 64, 2
#: published width: B=1, GRAD_TOKENS tokens (SSD_PROMPT with SSM heads;
#: llava GRAD_TOKENS patches beside them), 2 layers; the step-1 gradient
#: only
WIDE_LAYERS = 2
#: families held at reduced width only: one grok-1 layer and its
#: gradient are 48.7 GiB at 8 B a parameter before the unsharded run
WIDE_SKIP = ("grok-1-314b",)
#: two router probabilities closer than this may order differently
#: under another summation order (a routing flip)
ROUTING_TIE = 1e-6
SHARDED_TIMEOUT = 900
#: the expert-internal-TP case's name
EXPERT_TP = "expert-tp"


def expert_tp_config():
    """Reduced grok-1-314b in float32 with 3 experts: ``model`` = 2 does
    not divide them, so ``param_shardings`` takes the experts' d_ff over
    ``model`` (expert-internal TP, grok's route on 16 cards) where 4 or
    8 experts would shard over it (EP)."""
    from repro_torch.configs import reduced_config
    cfg = reduced_config("grok-1-314b")
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, num_experts=3))


def sharded_cases(width="reduced", archs=SHARDED_ARCHS, expert_tp=True):
    """Phase 19's cases: at reduced width (``configs.reduced_config`` in
    float32, B=4 x S=64, 2 AdamW steps) each family on (2, 2) with
    sequence parallelism off and on, the MoE families also on (2, 2, 1),
    and the expert-internal-TP case (``expert_tp_config``) on (2, 2) off
    and on; at published width each family but WIDE_SKIP at 2 layers
    (the encoder cut alike, WIDE_LAYERS) on (1, 2) off and on, the
    step-1 gradient only; each leaf seeded on the device
    (``case_leaves``). Each case: name, arch, config, mesh key, SP flag,
    batch, sequence, patches, AdamW steps, seeds, width."""
    from repro_torch.configs import reduced_config
    out = []

    def add(arch, cfg, meshes, **kw):
        for mesh, sp in meshes:
            name = f"{arch} {mesh}{' sp' if sp else ''}"
            out.append(dict(name=name, arch=arch, cfg=cfg, mesh=mesh, sp=sp,
                            seed=19, data_seed=5, **kw))

    for arch in archs:
        if width == "reduced":
            cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
            meshes = [("2x2", False), ("2x2", True)]
            if arch in SHARDED_MOE:
                meshes.append(("2x2x1", False))
            add(arch, cfg, meshes, batch=SHARDED_BATCH, seq=SHARDED_SEQ,
                patches=cfg.num_patches if cfg.frontend == "patches" else 0,
                steps=SHARDED_STEPS, width="reduced")
        elif arch not in WIDE_SKIP:
            cfg = dataclasses.replace(get_config(arch),
                                      num_layers=WIDE_LAYERS,
                                      dtype="float32")
            if cfg.enc_dec:
                cfg = dataclasses.replace(cfg, encoder_layers=WIDE_LAYERS)
            seq = SSD_PROMPT if cfg.ssm is not None else GRAD_TOKENS
            patches = GRAD_TOKENS if cfg.frontend == "patches" else 0
            add(arch, cfg, [("1x2", False), ("1x2", True)], batch=1,
                seq=seq + patches, patches=patches, steps=0,
                width="published")
    if width == "reduced" and expert_tp:
        cfg = expert_tp_config()
        add(EXPERT_TP, cfg, [("2x2", False), ("2x2", True)],
            batch=SHARDED_BATCH, seq=SHARDED_SEQ, patches=0,
            steps=SHARDED_STEPS, width="reduced")
    return out


def sharded_batches(case) -> list:
    """The case's batches (``steps``, at least one), numpy, the same on
    every rank: tokens and labels in [1, vocab), patches and frames
    normal and rounded to bf16 (the reference's batch dtype)."""
    cfg, b, s, np_ = case["cfg"], case["batch"], case["seq"], case["patches"]
    rng = np.random.default_rng(case["data_seed"])
    out = []
    for _ in range(max(1, case["steps"])):
        x = {k: rng.integers(1, cfg.vocab_size, (b, s - np_)).astype(
            np.int32) for k in ("tokens", "labels")}
        feat = {"patches": (np_, models_tf.VISION_EMBED_DIM),
                "frames": (s, models_tf.AUDIO_FEAT_DIM)}.get(cfg.frontend)
        if cfg.enc_dec or cfg.frontend == "patches":
            f = torch.from_numpy(rng.standard_normal(
                (b,) + feat).astype(np.float32))
            x[cfg.frontend] = f.to(torch.bfloat16).float().numpy()
        out.append(x)
    return out


def batch_tensor(name: str, v: np.ndarray, device) -> torch.Tensor:
    """One batch leaf as the model takes it: the frontend's features in
    bf16 (exact: they are bf16 values), token ids as int32."""
    t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return t.to(torch.bfloat16) if name in ("patches", "frames") else t


def case_leaves(case, device):
    """The case's parameters one leaf at a time (name, tensor on
    ``device``), in sorted order, each drawn as ``init_params`` draws it
    from a generator of its own (seeded by the case and the leaf's
    index), so that any rank and the unsharded run make the same leaf
    without holding the others."""
    defs = models_tf.param_defs(case["cfg"])
    for i, name in enumerate(sorted(defs)):
        gen = torch.Generator(device=device).manual_seed(
            case["seed"] * 100_003 + i)
        yield name, flatten(model_layers.init_from_defs(
            {name: defs[name]}, gen, model_layers._DTYPES[case["cfg"].dtype],
            device))[name]


#: the RoutingWatch open on this thread
_ROUTING = threading.local()
_ROUTING_LOCK = threading.Lock()


def _watched_top_k(top_k, probs, k):
    w, i = top_k(probs, k)
    watch = getattr(_ROUTING, "watch", None)
    # the forward's calls only: a backward's recomputation (remat) may
    # stop before the router on one run and not on another
    if watch is not None and torch._C._current_graph_task_id() == -1:
        def whole(x):
            x = x.detach()
            return (x.full_tensor() if hasattr(x, "full_tensor") else x
                    ).cpu().numpy()
        watch.calls.append((whole(probs).astype(np.float64), whole(i)))
    return w, i


class RoutingWatch:
    """While open on a thread, records each MoE router call of that
    thread's forward passes (``ffn.top_k``; not a backward's
    recomputation): the router probabilities and the experts picked,
    gathered whole on a DTensor (a collective every rank makes, at the
    same calls). Wraps ``ffn.top_k`` for good on first use; the
    wrapper does nothing on a thread with no watch open."""

    def __enter__(self):
        from repro_torch.models import ffn
        self.calls = []
        with _ROUTING_LOCK:
            if getattr(ffn.top_k, "func", None) is not _watched_top_k:
                ffn.top_k = functools.partial(_watched_top_k, ffn.top_k)
        _ROUTING.watch = self
        return self

    def __exit__(self, *exc):
        _ROUTING.watch = None
        return False


def routing_flips(got: list, want: list, k: int) -> dict:
    """Two runs' router calls, call by call: the smallest top-k margin of
    each (the k-th largest probability less the next), the tokens whose
    expert set differs, and the largest margin of any such token in
    either run (a flip is a near-tie only if it sits below
    ROUTING_TIE in both)."""
    if len(got) != len(want):
        raise AssertionError(f"router calls {len(got)} != {len(want)}")
    out = {"calls": len(got), "tokens": 0, "margin": float("inf"),
           "flipped": 0, "flip_margin": 0.0}

    def margins(p):
        s = -np.sort(-p, axis=-1)
        return s[:, k - 1] - s[:, k] if s.shape[1] > k else \
            np.full(len(s), np.inf)

    for (pg, ig), (pw, iw) in zip(got, want):
        mg, mw = margins(pg), margins(pw)
        differ = (np.sort(ig, -1) != np.sort(iw, -1)).any(-1)
        out["tokens"] += len(ig)
        out["margin"] = min(out["margin"], float(mg.min()), float(mw.min()))
        if differ.any():
            out["flipped"] += int(differ.sum())
            out["flip_margin"] = max(out["flip_margin"], float(
                mg[differ].max()), float(mw[differ].max()))
    return out


def _whole(x) -> np.ndarray:
    """A tensor or DTensor (gathered: a collective) as float32 numpy."""
    x = x.detach()
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.float().cpu().numpy()


def state_numpy(params, opt) -> dict:
    """A training state (parameters and AdamW state; DTensors gathered)
    as numpy by leaf name."""
    return {"params": {k: _whole(v) for k, v in flatten(params).items()},
            "m": {k: _whole(v) for k, v in flatten(opt["m"]).items()},
            "v": {k: _whole(v) for k, v in flatten(opt["v"]).items()},
            "step": int(_whole(opt["step"]))}


def state_tensors(state: dict, device):
    """``state_numpy``'s state as plain tensors on ``device``: (params,
    AdamW state)."""
    def tree(flat):
        return unflatten({k: torch.from_numpy(np.array(v)).to(device)
                          for k, v in flat.items()})
    return tree(state["params"]), {
        "m": tree(state["m"]), "v": tree(state["v"]),
        "step": torch.tensor(state["step"], dtype=torch.int32,
                             device=device)}


def family_steps(params, batches, cfg, steps: int, held=None, opt=None,
                 keep=False, watch=None) -> dict:
    """``make_train_step``'s step, unrolled so that its gradient is kept:
    per batch ``value_and_grad`` and, with ``steps``, ``adamw_update``
    (AdamW's defaults; from ``opt``, else a fresh state). Works on plain
    tensors and on DTensors (under the caller's activation hints).
    Returns the parameters after, the losses, each batch's gradient tree,
    each step's ms (host clock around a synchronisation), with ``keep``
    the state before each step after the first (``state_numpy``, by the
    step's index), and with ``watch`` (an
    open ``RoutingWatch``) each step's router calls. ``held`` (a
    ``HeldTraining``) is armed for the last batch."""
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.train_loop import value_and_grad
    device = next(iter(flatten(params).values())).device
    if steps and opt is None:
        opt = init_opt_state(params)
    out = {"losses": [], "grads": [], "step_ms": [], "states": {},
           "routing": []}
    for i, batch in enumerate(batches):
        if held is not None:
            held.armed = i == len(batches) - 1
        if keep and i:
            out["states"][i] = state_numpy(params, opt)
        calls = len(watch.calls) if watch is not None else 0
        _sync(device)
        t0 = time.perf_counter()
        loss, g = value_and_grad(params, batch, cfg)
        if steps:
            params, opt, _ = adamw_update(params, g, opt, AdamWConfig())
        loss = float(_whole(loss))
        _sync(device)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["grads"].append(g)
        if watch is not None:
            out["routing"].append(watch.calls[calls:])
    out["params"] = params
    return out


def _numpy_run(run: dict) -> dict:
    """``family_steps``' result with its trees gathered to numpy (reduced
    width: small)."""
    return dict(run, grads=[{k: _whole(v) for k, v in flatten(g).items()}
                            for g in run["grads"]],
                params={k: _whole(v) for k, v in
                        flatten(run["params"]).items()})


def unsharded_family(case, device):
    """The case's steps on plain tensors on one device from its starting
    parameters: losses, step ms, router calls per step, and at reduced
    width each step's gradient, the state before each step and the
    parameters after (numpy by leaf name). At published width the
    gradient goes to the host as CPU tensors (``want``) for the ranks to
    compare their shards with, each leaf's scale (``finite_scale``,
    taken on the device) beside it (``scale``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = unflatten(dict(case_leaves(case, device)))
    batches = [{k: batch_tensor(k, v, device) for k, v in b.items()}
               for b in sharded_batches(case)]
    with RoutingWatch() as watch:
        run = family_steps(params, batches, case["cfg"], case["steps"],
                           keep=case["width"] == "reduced", watch=watch)
    if case["width"] == "published":
        grads = flatten(run["grads"][0])
        return dict(run, params=None, grads=None, scale={
            k: finite_scale(v) for k, v in grads.items()}, want={
            k: v.detach().cpu() for k, v in grads.items()})
    return _numpy_run(run)


#: elements a device-side pass over a large leaf takes at a time (its
#: temporaries stay ~256 MiB however large the leaf)
CHUNK_ELEMENTS = 1 << 26


def finite_scale(x: torch.Tensor) -> tuple:
    """(largest finite |element|, whether any element is non-finite) of a
    tensor, on its device, a chunk at a time."""
    flat = x.detach().reshape(-1)
    top, bad = 0.0, False
    for i in range(0, flat.numel(), CHUNK_ELEMENTS):
        c = flat[i:i + CHUNK_ELEMENTS]
        fin = torch.isfinite(c)
        bad = bad or not bool(fin.all())
        top = max(top, float(c.abs().masked_fill_(~fin, 0).max()))
    return top, bad


def equal_input_step(case, state: dict, index: int, device) -> dict:
    """One AdamW step on plain tensors from a sharded run's own state
    before its step ``index`` (0-based; ``state_numpy``'s) on that step's
    batch: the unsharded step at equal inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params, opt = state_tensors(state, device)
    batch = {k: batch_tensor(k, v, device)
             for k, v in sharded_batches(case)[index].items()}
    with RoutingWatch() as watch:
        run = family_steps(params, [batch], case["cfg"], 1, opt=opt,
                           watch=watch)
    return _numpy_run(run)


def local_agreement(grads, want: dict, device) -> dict:
    """Each gradient leaf's local shard against the same slice of the
    unsharded gradient (``want``: CPU tensors by leaf name), a block of
    rows at a time on the device (CHUNK_ELEMENTS each; only the block
    goes to the device): per leaf whether the non-finite elements agree
    and the largest |difference| over the finite ones. No leaf is
    gathered."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    out = {}
    for k, g in flatten(grads).items():
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, [
                Replicate() if p.is_partial() else p for p in g.placements])
        shape, offset = compute_local_shape_and_global_offset(
            g.shape, g.device_mesh, g.placements)
        x = g.to_local()
        if x.dim() == 0:
            x, shape, offset = x.reshape(1), (1,), (0,)
            w_host = want[k].reshape(1)
        else:
            w_host = want[k]
        rest = tuple(slice(o, o + n) for o, n in zip(offset[1:], shape[1:]))
        rows = max(1, CHUNK_ELEMENTS // max(1, math.prod(shape[1:])))
        same, diff = True, 0.0
        for a in range(0, shape[0], rows):
            b = min(a + rows, shape[0])
            w = w_host[(slice(offset[0] + a, offset[0] + b),) + rest].to(
                device)
            xa = x[a:b]
            fin = torch.isfinite(w)
            same = same and bool(torch.equal(fin, torch.isfinite(xa)))
            if fin.any():
                diff = max(diff, float((xa - w).abs_().masked_fill_(
                    ~fin, 0).max()))
        out[k] = (same, diff)
    return out


def own_shard(x):
    """A DTensor whose local shard holds its own storage: where
    ``distribute_tensor`` kept a view of the whole leaf (a shard on dim
    0), the shard is copied so that the whole leaf can be freed."""
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    if local.untyped_storage().nbytes() <= local.numel() * \
            local.element_size():
        return x
    return DTensor.from_local(local.clone(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _sharded_case(mesh, case, device):
    """One case of ``sharded_world`` on this rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.constraints import activation_mesh
    cfg, on_card = case["cfg"], torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dist.barrier()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    specs = flatten(shd.param_shardings(cfg, mesh))
    params = unflatten({k: own_shard(distribute_tensor(
        v, mesh, shd.placements(specs[k], mesh), src_data_rank=None))
        for k, v in case_leaves(case, device)})
    batches = [{k: distribute_tensor(
        batch_tensor(k, v, device), mesh, shd.placements(
            shd.batch_sharding(mesh, v.shape), mesh), src_data_rank=None)
        for k, v in b.items()} for b in sharded_batches(case)]
    before = dict(_build.thread_launches())
    reduced = case["width"] == "reduced"
    # the backward on this rank's thread: its launches are this thread's
    with activation_mesh(mesh, sequence_parallel=case["sp"]), \
            implicit_replication(), \
            torch.autograd.set_multithreading_enabled(False), \
            RoutingWatch() as watch, HeldTraining() as held:
        run = family_steps(params, batches, cfg, case["steps"],
                           held if on_card else None, keep=reduced,
                           watch=watch)
        # the step's peak and launches, before the checks below allocate
        # (and may launch)
        _sync(device)
        dist.barrier()
        rec = {"rank": rank, "peak_gib": torch.cuda.max_memory_allocated()
               / 2 ** 30 if on_card else 0.0, "launches": {
                   k: v - before.get(k, 0)
                   for k, v in _build.thread_launches().items()
                   if v != before.get(k, 0)}}
        rec.update(held=held.check(f"{case['name']} rank {rank}")
                   if on_card and held.fwd else {}, shapes=dict(held.shapes))
    del params, batches
    if reduced:
        rec.update(_numpy_run(run))
    else:
        run["params"] = None
        rec.update(run, grads=None,
                   local=local_agreement(run["grads"][0], case["want"],
                                         device))
    del run
    _sync(device)
    dist.barrier()
    return rec


def sharded_world(mesh, cases, device="cuda"):
    """Phase 19 on each rank of ``mesh``, case by case (a case of another
    mesh of as many ranks on a ``DeviceMesh`` of its own): each case's
    parameters placed by ``param_shardings`` (every rank makes each leaf
    and keeps its shard; none is sent) and its batches by
    ``batch_sharding``, then its steps (``family_steps``) under
    ``activation_mesh(mesh, sequence_parallel=)`` and
    ``implicit_replication``, the MoE router calls recorded and, on the
    card, the last step's flash forward and backward launches held
    against the plain versions. Returns this rank's record per case:
    losses, step ms, launches, local q shapes, peak GiB and at reduced
    width the step-1 gradient and the parameters after, gathered; at
    published width each gradient leaf held shard by shard against the
    case's ``want``."""
    from repro_torch.launch.mesh import device_mesh
    out, meshes = {}, {}
    for case in cases:
        shape, axes = SHARDED_MESHES[case["mesh"]]
        if tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes:
            here = mesh
        else:       # another mesh over the same ranks
            here = meshes.setdefault(case["mesh"], device_mesh(
                shape, axes, device))
        out[case["name"]] = _sharded_case(here, case, device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def sharded_local_shape(case):
    """The q shape rows 5 and 5b see on a rank of the case's mesh: the
    batch split over (pod, data) where it divides, the whole sequence
    (gathered under sequence parallelism), the KV heads split over
    ``model`` where it divides them (MLA: its heads, one a group)."""
    cfg = case["cfg"]
    sizes = dict(zip(SHARDED_MESHES[case["mesh"]][1],
                     SHARDED_MESHES[case["mesh"]][0]))
    dp = sizes.get("pod", 1) * sizes["data"]
    tp = sizes["model"]
    if cfg.attention == "mla":
        kvh, dh = cfg.num_heads, cfg.mla.qk_nope_head_dim + \
            cfg.mla.qk_rope_head_dim
    else:
        kvh, dh = cfg.num_kv_heads, cfg.head_dim
    b = case["batch"] // dp if case["batch"] % dp == 0 else case["batch"]
    return (b, case["seq"], kvh // tp if kvh % tp == 0 else kvh,
            cfg.num_heads // kvh, dh)


def _step_agreement(got: dict, want: dict, k: int, tol: float,
                    moe) -> dict:
    """Step ``k`` of a sharded run against the unsharded step at equal
    inputs (``want``: its loss, gradient, parameters after and router
    calls, numpy): the loss and the gradient's worst leaf, held within
    ``tol``; the parameters after, held as phase 18 holds them
    (``param_agreement`` with this step's unsharded gradient as each
    element's and the gradients' gap, ELASTIC_TOL but for isolated AdamW
    sign flips); the router's expert sets (``routing_flips``)."""
    g = got["grads"][k]
    w = want["grads"][-1]
    params = got["states"][k + 1]["params"] if k + 1 in got["states"] \
        else got["params"]
    gap = {n: float(np.abs(g[n].astype(np.float64) - x).max())
           for n, x in w.items()}
    out = {"loss": abs(got["losses"][k] - want["losses"][-1]) /
           abs(want["losses"][-1]),
           "grads": worst_leaf(g, w),
           "params": param_agreement(params, want["params"], 1, w, gap)}
    if moe is not None:
        out["routing"] = routing_flips(got["routing"][k],
                                       want["routing"][-1], moe.top_k)
    return out


def sharded_checks(case, want: dict, recs: list, tol: float,
                   on_card=True) -> dict:
    """Holds one case's ranks against the unsharded steps: every rank the
    same finite losses. At reduced width each AdamW step against the
    unsharded step at equal inputs (step 1: the same start; a later
    step: the sharded run's own state before it, ``want["replays"]``;
    ``_step_agreement``): its loss and gradient within ``tol``, its
    parameters within ELASTIC_TOL but for isolated sign flips
    (ADAM_FLIPS / ADAM_REACH); the whole trajectory against the
    unsharded one is returned beside, not held (sign-sized first updates
    part the runs where a gradient sits at their difference, and each
    later step starts from the parted state). At published width the
    loss within ``tol`` and each gradient leaf, shard by shard,
    non-finite exactly where the unsharded one is and within ``tol``
    elsewhere. The MoE router's expert sets at equal inputs must be
    equal but at near-ties: a token whose set differs must sit below
    ROUTING_TIE in both runs. On the card rows 5 and 5b launched as the
    case's layers and steps need, on the tf32x3 routes only, on the
    expected local shards. Returns the summary the phase prints; raises
    on any miss."""
    name, cfg = case["name"], case["cfg"]
    if len({tuple(r["losses"]) for r in recs}) != 1 or \
            not all(np.isfinite(recs[0]["losses"])):
        raise AssertionError(f"{name}: losses {[r['losses'] for r in recs]}")
    x = recs[0]
    out = {}
    if case["width"] == "published":
        out["loss"] = abs(x["losses"][0] - want["losses"][0]) / \
            abs(want["losses"][0])
        leaves = {}
        for r in recs:
            for k, (same, diff) in r["local"].items():
                s, d = leaves.get(k, (True, 0.0))
                leaves[k] = (s and same, max(d, diff))
        scale = want["scale"]
        floor = 1e-6 * max(t for t, _ in scale.values())
        bad = [k for k, (s, _) in leaves.items() if not s]
        if bad:
            raise AssertionError(f"{name}: gradient leaves {bad} non-finite "
                                 f"where the unsharded run's are not, or "
                                 f"the reverse")
        out["grads"] = max((d / max(scale[k][0], floor, 1e-30), k)
                           for k, (_, d) in leaves.items())
        out["nonfinite"] = sorted(k for k, (_, bad) in scale.items() if bad)
        if cfg.moe is not None:
            out["routing"] = routing_flips(x["routing"][0],
                                           want["routing"][0], cfg.moe.top_k)
    else:
        steps = []
        for k in range(case["steps"]):
            ref = want["replays"][k] if k else {
                "losses": want["losses"][:1], "grads": want["grads"][:1],
                "routing": want["routing"][:1],
                "params": want["states"][1]["params"]
                if 1 in want["states"] else want["params"]}
            steps.append(_step_agreement(x, ref, k, tol, cfg.moe))
        out["loss"] = max(s["loss"] for s in steps)
        out["grads"] = max(s["grads"] for s in steps)
        out["params"] = max(s["params"]["worst"] for s in steps)
        out["flips"] = [s["params"]["beyond"] for s in steps]
        out["reach"] = max(s["params"]["reach"] for s in steps)
        for s in steps:
            p = s["params"]
            if not all(n <= ADAM_FLIPS * size for n, size in
                       p["beyond"].values()) or p["reach"] > ADAM_REACH:
                raise AssertionError(f"{name}: parameters {p}: past "
                                     f"{ELASTIC_TOL} beyond isolated AdamW "
                                     f"sign flips at equal inputs")
        if cfg.moe is not None:
            r = [s["routing"] for s in steps]
            out["routing"] = {
                "calls": sum(z["calls"] for z in r),
                "tokens": sum(z["tokens"] for z in r),
                "margin": min(z["margin"] for z in r),
                "flipped": sum(z["flipped"] for z in r),
                "flip_margin": max(z["flip_margin"] for z in r)}
        trajectory = param_agreement(
            x["params"], want["params"], case["steps"], want["grads"][0], {
                k: 0.0 for k in want["params"]})
        out["trajectory"] = {
            "loss": max(abs(a - b) / abs(b) for a, b in
                        zip(x["losses"], want["losses"])),
            "params": trajectory["worst"], "beyond": trajectory["beyond"],
            "reach": trajectory["reach"]}
    if out["loss"] > tol or out["grads"][0] > tol:
        raise AssertionError(f"{name}: sharded against unsharded loss "
                             f"{out['loss']:.3g}, gradient {out['grads']}; "
                             f"limit {tol}")
    if "routing" in out and out["routing"]["flipped"] and \
            out["routing"]["flip_margin"] >= ROUTING_TIE:
        raise AssertionError(f"{name}: routing flips away from a near-tie: "
                             f"{out['routing']}")
    if on_card:
        n = max(1, case["steps"])
        layers = attention_layers(cfg)[0]
        expect = {"flash_attention_causal": n * grad_flash_launches(cfg),
                  "flash_attention_causal_bwd": n * layers}
        for op in list(expect):
            expect[f"{op}/tf32x3"] = expect[op]
        expect.update({f"flash_attention_causal_bwd/{k}": n * layers
                       for k in flash_mod.BWD_KERNELS})
        expect = {k: v for k, v in expect.items() if v}
        local = sharded_local_shape(case) if layers else None
        for r in recs:
            if r["launches"] != expect:
                raise AssertionError(f"{name} rank {r['rank']}: launches "
                                     f"{r['launches']}, expected {expect}")
            if layers and set(r["shapes"]) != {local}:
                raise AssertionError(f"{name} rank {r['rank']}: local q "
                                     f"shapes {r['shapes']}, expected "
                                     f"{local}")
    return out


def with_replays(case, want: dict, got: dict, device) -> dict:
    """``want`` (the unsharded run) with, at reduced width, each later
    step again from the sharded run's (``got``'s) own state before it
    (``equal_input_step``), by step index."""
    if case["width"] != "reduced" or "states" not in got:
        return want
    return dict(want, replays={
        k: equal_input_step(case, got["states"][k], k, device)
        for k in range(1, case["steps"])})


def sharded_run(cases, mesh_key: str, device="cuda"):
    """The cases of one mesh: each config's unsharded run on this
    process's device first (once for the cases that share it), then one
    world of the mesh's ranks (``elastic_launcher``) over all of them,
    then at reduced width each later step again unsharded from the
    sharded run's own state before it (``equal_input_step``,
    ``replays`` by step). Returns (substrate, ranks' records, the
    unsharded runs by case name, the world's seconds)."""
    unsharded, wants = {}, {}
    for case in cases:
        key = (case["arch"], case["width"])
        if key not in unsharded:
            unsharded[key] = unsharded_family(case, device)
        wants[case["name"]] = unsharded[key]
        if "want" in unsharded[key]:
            case["want"] = unsharded[key]["want"]
    shape, axes = SHARDED_MESHES[mesh_key]
    n = int(np.prod(shape))
    launch, substrate = elastic_launcher(n, device)
    t0 = time.perf_counter()
    recs = launch(functools.partial(sharded_world, cases=cases,
                                    device=device), n, device,
                  timeout=SHARDED_TIMEOUT, mesh=(shape, axes))
    secs = time.perf_counter() - t0
    for case in cases:
        wants[case["name"]] = with_replays(case, wants[case["name"]],
                                           recs[0][case["name"]], device)
    return substrate, recs, wants, secs


def _case_line(case, out: dict, recs: list, want: dict, substrate: str,
               smi: str) -> str:
    """Phase 19's line for one case."""
    cfg = case["cfg"]
    shape, axes = SHARDED_MESHES[case["mesh"]]
    x = recs[0]
    held = ("; at equal inputs per step (step 1 from the seeded start, "
            "step 2 from the sharded run's own state): parameters worst "
            f"{out['params']}, AdamW elements past {ELASTIC_TOL} per step "
            f"{out['flips']} (reach {out['reach']:.3g} lr); the 2-step "
            f"trajectory against the unsharded one, not held: "
            f"{out['trajectory']}") if case["width"] == "reduced" else (
        f"; non-finite leaves (the same in both runs) {out['nonfinite']}")
    return (f"sharded {case['name']} ({case['width']} width: "
            f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads} / {cfg.num_kv_heads} heads, float32, B="
            f"{case['batch']} S={case['seq']}, {max(1, case['steps'])} "
            f"step(s)) on {shape} {axes}, sequence parallelism "
            f"{'on' if case['sp'] else 'off'}, {substrate}: loss worst "
            f"{out['loss']:.3g}, gradient worst {out['grads']}" + held +
            f"; routing {out.get('routing', 'no MoE')}; step ms per rank "
            f"{[[round(t, 1) for t in r['step_ms']] for r in recs]} "
            f"(unsharded {[round(t, 1) for t in want['step_ms']]}); peak "
            f"GiB {x['peak_gib']:.3f}; launches per rank {x['launches']}; "
            f"local q shapes {x['shapes']}; held launches (rank 0) "
            f"{x['held']}; {smi}")


#: phase 19's parts: the reduced cases by mesh, sequence parallelism and
#: half of the families (SHARDED_HALVES), then the published widths. The
#: smoke runs each in a process of its own: a world's thread ranks share
#: one interpreter, so DTensor's planning runs one rank at a time, and
#: five reduced worlds plan on five cores
SHARDED_PARTS = ("reduced 2x2 a", "reduced 2x2 b", "reduced 2x2 sp a",
                 "reduced 2x2 sp b", "reduced 2x2x1", "published")
#: the reduced families in two halves of about equal time on the card
#: (the MoE, expert-internal-TP and hybrid cases plan the most ops)
SHARDED_HALVES = {"a": SHARDED_MOE + ("hymba-1.5b", EXPERT_TP)}
SHARDED_HALVES["b"] = tuple(a for a in SHARDED_ARCHS
                            if a not in SHARDED_HALVES["a"])


def sharded_plan(parts=SHARDED_PARTS) -> list:
    """[(label, mesh key, cases)] for ``parts``: a reduced part's cases
    (``reduced <mesh> [sp] [half]``) in one world of its mesh, each
    published family's two cases in a world of (1, 2) ranks."""
    plan = []
    reduced = sharded_cases("reduced") if any(
        p.startswith("reduced") for p in parts) else []
    for part in parts:
        if part == "published":
            wide = sharded_cases("published")
            for arch in dict.fromkeys(c["arch"] for c in wide):
                plan.append((f"1x2 {arch}", "1x2",
                             [c for c in wide if c["arch"] == arch]))
            continue
        _, key, *rest = part.split()
        archs = SHARDED_HALVES.get(rest[-1]) if rest else None
        plan.append((part, key, [
            c for c in reduced if c["mesh"] == key and c["sp"] == (
                "sp" in rest) and (archs is None or c["arch"] in archs)]))
    return plan


def sharded_phase(device="cuda", parts=SHARDED_PARTS):
    """Phase 19 (see the module doc), ``sharded_plan``'s worlds one after
    another; each case held by ``sharded_checks`` (GRAD_TOL) and
    printed. Returns rows 5 and 5b's launches summed over every rank of
    every world."""
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    smi = nvidia_smi()
    total = collections.Counter()
    secs = {}
    for label, key, cases in sharded_plan(parts):
        substrate, recs, wants, secs[label] = sharded_run(cases, key, device)
        for case in cases:
            rr = [r[case["name"]] for r in recs]
            out = sharded_checks(case, wants[case["name"]], rr, GRAD_TOL,
                                 on_card)
            log(_case_line(case, out, rr, wants[case["name"]], substrate,
                           smi))
            for r in rr:
                total.update(r["launches"])
            case.pop("want", None)
        del recs, wants
        if on_card:
            torch.cuda.empty_cache()
    log(f"sharded families {list(parts)}: launches over every rank "
        f"{dict(total)}; world seconds "
        f"{ {k: round(v, 1) for k, v in secs.items()} }; published widths "
        f"skip {WIDE_SKIP} (one grok-1 layer and its gradient are 48.7 "
        f"GiB at 8 B a parameter); {time.perf_counter() - t0:.1f} s; {smi}")
    return dict(total)


def sharded_child(part: str, out: str) -> None:
    """A child process's phase 19 part (``start_sharded``): its lines to
    stdout, the launches summed over its ranks to ``out`` (JSON); an
    exception ends the process with a nonzero code. Two threads for its
    CPU ops: the parts run beside each other and the smoke."""
    torch.set_num_threads(2)
    total = sharded_phase(parts=(part,))
    Path(out).write_text(json.dumps(total))


def start_sharded(tmp: str, parts=SHARDED_PARTS) -> list:
    """Phase 19's parts, each in a process of its own (``python -c``
    ``sharded_child``), started together: they run beside what the
    smoke does next (host work on other cores; the card has room), each
    writing its output to a file in ``tmp``. Returns [(part, process,
    output file, launches file)]."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = []
    for part in parts:
        stem = part.replace(" ", "_")
        log_path, js = Path(tmp) / f"{stem}.log", Path(tmp) / f"{stem}.json"
        with open(log_path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke."
                 f"sharded_child({part!r}, {str(js)!r})"], cwd=root,
                env=env, stdout=f, stderr=subprocess.STDOUT, text=True)
        out.append((part, proc, log_path, js))
    return out


def finish_sharded(children) -> dict:
    """Waits for ``start_sharded``'s processes, prints each one's phase 19
    lines and raises if any failed. Returns the launches summed over
    every rank of every world."""
    total = collections.Counter()
    failed = []
    deadline = time.monotonic() + SHARDED_TIMEOUT
    for part, proc, log_path, js in children:
        try:
            proc.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        text = log_path.read_text()
        for line in text.splitlines():
            if line.startswith("sharded ") or proc.returncode:
                log(line)
        if proc.returncode or not js.exists():
            failed.append((part, proc.returncode))
            continue
        total.update(json.loads(js.read_text()))
    if failed:
        raise AssertionError(f"phase 19: {failed} (part, exit code) failed")
    return dict(total)


def stop_children(children) -> None:
    """Kills ``start_sharded``'s processes that still run."""
    for _, proc, _, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


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
    # the processes and files a phase leaves open are closed on the way out
    with contextlib.ExitStack() as stack:
        return _main(stack)


def _main(stack) -> int:
    t_start = time.perf_counter()
    #: (phase, its start on the host clock): each phase's seconds at the end
    clock = [("1-2 environment, build", t_start)]

    def phase(name):
        clock.append((name, time.perf_counter()))

    smi = nvidia_smi()
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}; nvidia-smi: {smi}; host "
        f"memory available {host_free_gib():.1f} GiB, {os.cpu_count()} "
        f"cores")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        built = list(pool.map(_build.build, SOURCES))
    log(f"build: {len(SOURCES)} sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (path, nvcc_out) in zip(SOURCES, built):
        log(f"  {name}: {path}")
        for line in ptxas_summary(nvcc_out):
            log(f"    ptxas: {line}")

    phase("3 kernels")
    rows = kernel_phase()
    t0 = time.perf_counter()
    rows.update(attention_phase())
    log(f"attention kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows.update(bwd_attention_phase())
    log(f"attention backward kernel: {time.perf_counter() - t0:.1f} s")

    phase("4-5 main path, cpu replay")
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
    phase("6 paged path")
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
    phase("7-8 serving, replay")
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
            "flash_attention_causal/tf32x3": 0,
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
    phase("9 service")
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
    phase("10 baselines")
    for name, stats, ms, rate in baselines_phase():
        log(f"baseline {name}: {stats}; {ms:.3f} ms a batch on the card "
            f"(warm) = {rate:.1f} committed txn/s; card == cpu "
            f"(base, reads, stats)")
    log(f"baselines: {time.perf_counter() - t0:.1f} s")

    # -- the protocol arena, counted from zero -----------------------------
    phase("11 arena")
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
    phase("12 audited store")
    audit_phase()

    # -- the paper's remaining suites, counted from zero --------------------
    phase("13 paper suites")
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
    phase("14 models")
    t0 = time.perf_counter()
    model_launches = models_phase()
    for name in ("decode_attention", "flash_attention_causal"):
        rows[name]["models_launches"] = model_launches.get(name, 0)
    log(f"models path: bf16 launches over the {len(MODEL_ARCHS)} "
        f"configurations "
        f"{model_launches}; {time.perf_counter() - t0:.1f} s; {nvidia_smi()}")

    # -- the training path, counted from zero per step ----------------------
    phase("15 training")
    tmp19 = stack.enter_context(tempfile.TemporaryDirectory())
    children = []
    stack.callback(stop_children, children)

    def start_phase_19():
        # phase 19's processes start before phase 15's launchers and run
        # beside them and phases 16-18: the timed parts are done
        torch.cuda.empty_cache()
        children.extend(start_sharded(tmp19))
        clock.append(("15 training (the launchers)", time.perf_counter()))

    train_launches, step_ms, mla_launches, f32_bwd, families = \
        training_phase(before_launchers=start_phase_19)
    rows["flash_attention_causal_bwd/tf32x3"]["launches"] = f32_bwd
    for name in ("flash_attention_causal", "flash_attention_causal_bwd"):
        rows[name]["family_training_launches"] = families[name]
    rows["flash_attention_causal_bwd"]["launches"] = \
        train_launches["flash_attention_causal_bwd"]
    rows["flash_attention_causal_bwd"]["mla_training_launches"] = \
        mla_launches["flash_attention_causal_bwd"]
    rows["flash_attention_causal"]["training_launches"] = \
        train_launches["flash_attention_causal"]
    rows["flash_attention_causal"]["mla_training_launches"] = \
        mla_launches["flash_attention_causal"]

    # -- the roofline of the training step and the sharded path -------------
    phase("16 roofline")
    roofline_phase(step_ms)

    # -- the mesh= substrate, counted from zero -----------------------------
    phase("17 mesh")
    mesh_launches = mesh_phase()
    for name in ("mvcc_resolve", "mvcc_resolve_masked",
                 "mvcc_resolve_paged"):
        rows[name]["mesh_launches"] = mesh_launches[name]

    # -- the elastic restart, counted from zero per rank --------------------
    phase("18 elastic restart")
    el = elastic_phase()
    for name in ("flash_attention_causal", "flash_attention_causal_bwd",
                 "flash_attention_causal_bwd/tf32x3"):
        rows[name]["elastic_launches"] = el.get(name, 0)

    # -- the sharded families, started in phase 15, counted per rank -------
    phase("19 sharded families (the rest)")
    sh = finish_sharded(children)
    for name in ("flash_attention_causal", "flash_attention_causal_bwd",
                 "flash_attention_causal_bwd/tf32x3"):
        rows[name]["sharded_launches"] = sh.get(name, 0)
    started = dict(clock)["15 training (the launchers)"]
    log(f"sharded families: launches over every rank of every part {sh}; "
        f"{len(children)} processes started {started - t_start:.1f} s into "
        f"the smoke, beside phase 15's launchers and phases 16-18, joined "
        f"{time.perf_counter() - started:.1f} s later; {nvidia_smi()}")

    phase("end")
    secs = {name: round(end - start, 1)
            for (name, start), (_, end) in zip(clock, clock[1:])}
    log(f"phase seconds {secs}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
