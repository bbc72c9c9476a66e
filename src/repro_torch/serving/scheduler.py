"""Two-phase continuous-batching scheduler (Bohm's CC phase for serving).

A copy of ``repro.serving.scheduler`` (numpy host code, no translation)
on the port's ``MetricsRegistry`` and ``PhaseTracer``.

Host-side planning, device-side execution — the paper's architecture:

  CC phase (this module, plain numpy, runs ahead of the device):
    * admits requests into free slots, assigns each a timestamp from a
      single monotonic counter (the paper's dedicated timestamp thread);
    * plans every KV append for the upcoming step: (slot -> page, offset),
      allocating pages from the free list — placeholder versions;
    * resolves read-sets: a new request whose prompt prefix is cached
      simply points its page table at the shared pages (readers never
      block the writer that created them, and never write shared state);
    * retires pages of finished sequences into a pending list stamped with
      the current batch index.

  Execution phase (repro_torch/serving/engine.py): a decode step that
  consumes the plan arrays; zero scheduling logic on device.

  GC (Condition 3): pending pages from batch b return to the free list
  once watermark > b, where watermark advances when every sequence
  admitted before it has completed — never mid-batch.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import MetricsRegistry, PhaseTracer, scheduler_health


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [len] int32
    max_new_tokens: int
    ts: int = -1                    # assigned by the scheduler
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class StepPlan:
    """Everything the decode step needs, as arrays (the 'placeholders')."""
    active: np.ndarray              # [S] bool
    tokens: np.ndarray              # [S] int32 next input token per slot
    slot_pages: np.ndarray          # [S] int32 page receiving this token
    offsets: np.ndarray             # [S] int32 offset within that page
    positions: np.ndarray           # [S] int32 absolute position


class BohmScheduler:
    def __init__(self, *, slots: int, num_pages: int, page_size: int,
                 max_pages_per_seq: int,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[PhaseTracer] = None):
        self.slots = slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages = max_pages_per_seq
        self.free_pages = deque(range(num_pages))
        self.page_table = np.full((slots, max_pages_per_seq), -1, np.int64)
        self.seq_len = np.zeros(slots, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.queue: deque[Request] = deque()
        self.ts_counter = 0                      # the timestamp "thread"
        self.batch_idx = 0
        # Condition-3 GC state: pages retired at batch b + min live ts
        self.pending_free: deque[Tuple[int, List[int]]] = deque()
        self.finished: List[Request] = []
        # prefix cache: prompt hash -> page ids. Cached pages are pinned
        # (never recycled); eviction under pool pressure is out of scope.
        self.prefix_cache: Dict[bytes, List[int]] = {}
        self.cached_pages: set = set()
        # stats live under "serving/" in a MetricsRegistry (shared with
        # an engine's when one is passed in) — same keys / mutation sites
        # as the legacy dict
        self.metrics = registry or MetricsRegistry()
        self.stats = self.metrics.view("serving/")
        for key in ("admitted", "completed", "prefix_hits",
                    "pages_recycled"):
            self.stats[key] = 0
        # obs plane: admission / GC / planning decisions land as tracer
        # instants (zero-cost when tracing is off), occupancy gauges
        # evaluate lazily at registry.snapshot()
        self.tracer = tracer if tracer is not None \
            else PhaseTracer(enabled=False)
        self.metrics.register_gauge("serving/active_slots",
                                    lambda: self.num_active)
        self.metrics.register_gauge("serving/free_pages",
                                    lambda: len(self.free_pages))
        self.metrics.register_gauge("serving/queue_depth",
                                    lambda: len(self.queue))
        self.metrics.register_gauge(
            "serving/pending_free_pages",
            lambda: sum(len(p) for _, p in self.pending_free))

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _alloc_page(self) -> int:
        self._gc()
        if not self.free_pages:
            raise RuntimeError("KV page pool exhausted")
        return self.free_pages.popleft()

    def _gc(self) -> None:
        """Condition 3: recycle page groups whose retiring batch is below
        the watermark (= oldest batch any live sequence was admitted in)."""
        live_batches = [r.ts for r in self.slot_req if r is not None]
        watermark = min(live_batches) if live_batches else self.ts_counter
        recycled = 0
        while self.pending_free and self.pending_free[0][0] < watermark:
            _, pages = self.pending_free.popleft()
            for p in pages:
                self.free_pages.append(p)
                self.stats["pages_recycled"] += 1
                recycled += 1
        if recycled:
            self.tracer.instant("serving/gc", recycled=recycled,
                                watermark=watermark,
                                free_pages=len(self.free_pages))

    # ------------------------------------------------------------------
    def admit(self) -> List[Tuple[Request, Optional[List[int]]]]:
        """Fill free slots. Returns [(request, shared_prefix_pages|None)]
        for the engine to prefill."""
        admitted = []
        for s in range(self.slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.ts = self.ts_counter
            self.ts_counter += 1
            req.slot = s
            self.slot_req[s] = req

            shared = None
            key = req.prompt.tobytes()
            aligned = len(req.prompt) % self.page_size == 0
            hit = self.prefix_cache.get(key) if aligned else None
            n_prompt_pages = -(-len(req.prompt) // self.page_size)
            self.page_table[s, :] = -1
            if hit is not None:
                # read-set resolution (paper 4.1.3 optimisation): annotate
                # the request with references to the shared page versions.
                # Readers take no locks and write no shared state; the
                # cached pages are immutable versions, so appends by this
                # request go to its own fresh pages (copy-on-write).
                shared = list(hit)
                self.page_table[s, :len(shared)] = shared
                self.seq_len[s] = len(req.prompt)
                self.stats["prefix_hits"] += 1
            else:
                for i in range(n_prompt_pages):
                    self.page_table[s, i] = self._alloc_page()
                self.seq_len[s] = len(req.prompt)
                if aligned:
                    pages = [int(p) for p in
                             self.page_table[s, :n_prompt_pages]]
                    self.prefix_cache[key] = pages
                    self.cached_pages.update(pages)
            self.stats["admitted"] += 1
            self.tracer.instant("serving/admit", rid=req.rid, slot=s,
                                ts=req.ts, prefix_hit=shared is not None)
            admitted.append((req, shared))
        return admitted

    # ------------------------------------------------------------------
    def plan_step(self, next_tokens: Dict[int, int]) -> StepPlan:
        """CC phase for one decode step: place every active slot's next
        token append. ``next_tokens``: slot -> token id to feed."""
        S = self.slots
        active = np.zeros(S, bool)
        tokens = np.zeros(S, np.int64)
        slot_pages = np.zeros(S, np.int64)
        offsets = np.zeros(S, np.int64)
        positions = np.zeros(S, np.int64)
        for s, req in enumerate(self.slot_req):
            if req is None or req.done or s not in next_tokens:
                continue
            pos = int(self.seq_len[s])
            page_idx, off = divmod(pos, self.page_size)
            if page_idx >= self.max_pages:
                raise RuntimeError("sequence exceeded max pages")
            if self.page_table[s, page_idx] < 0:
                self.page_table[s, page_idx] = self._alloc_page()
            active[s] = True
            tokens[s] = next_tokens[s]
            slot_pages[s] = self.page_table[s, page_idx]
            offsets[s] = off
            positions[s] = pos
            self.seq_len[s] = pos + 1
        self.tracer.instant("serving/plan_step",
                            active=int(active.sum()),
                            free_pages=len(self.free_pages))
        return StepPlan(active, tokens.astype(np.int32),
                        slot_pages.astype(np.int32),
                        offsets.astype(np.int32),
                        positions.astype(np.int32))

    # ------------------------------------------------------------------
    def complete(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        req.done = True
        pages = [int(p) for p in self.page_table[slot]
                 if p >= 0 and int(p) not in self.cached_pages]
        # non-cached pages retire via Condition 3; cached prefix pages stay
        self.pending_free.append((self.batch_idx, pages))
        self.page_table[slot, :] = -1
        self.seq_len[slot] = 0
        self.slot_req[slot] = None
        self.finished.append(req)
        self.stats["completed"] += 1

    def end_batch(self) -> None:
        self.batch_idx = self.ts_counter   # watermark domain = admission ts
        self._gc()

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def health(self) -> Dict[str, object]:
        """Serving-plane health gauges (slot/page occupancy, queue depth,
        cache size) — see ``repro_torch.obs.scheduler_health``. Duck-
        compatible with ``HealthMonitor(target=...)``."""
        return scheduler_health(self)
