"""TxnService: the out-of-order batch scheduler on top of ``BohmEngine``
(port of ``repro.service.txn_service``).

The paper runs two thread pools so the CC phase of batch b+1 overlaps the
execution of batch b (§3, Fig. 3) and keeps ONE synchronisation point: the
batch barrier between exec epochs. The engine's phase graph (plan / exec /
commit as separate phase calls, ``BohmEngine._plan`` / ``_exec`` /
``_commit``) lets the scheduler go further.
Because Bohm assigns timestamps in a dedicated layer BEFORE execution,
the admission layer is free to pick the order: any permutation that only
swaps batches with disjoint (write vs read∪write) footprints commutes,
the plan phase simply assigns the reordered ts windows, and the result
is provably serial-equivalent — byte-identical reads per ticket.

  admission window  ``submit(batch, latency_class=...)`` enqueues a batch
                    (plus its read/write record bitset + uint64 signature,
                    computed in one pass at admission) and returns a
                    ticket; up to ``admission_window`` queued batches are
                    scanned per scheduling decision;
  epoch formation   instead of stopping at the first conflicting batch
    (reordering)    (the FIFO-prefix merge), the scanner *hops* it:
                    any later batch that commutes with every batch left
                    behind may join the epoch. Global timestamps are
                    re-derived from the DISPATCH order (``dispatch_log``)
                    and threaded through ``commit(..., ts_window=)``;
                    per-ticket results are re-associated so poll / wait /
                    drain still resolve in submission order;
  latency classes   ``latency_class="interactive"`` batches are scanned
                    first, so point txns jump the queue past bulk scans
                    they commute with (``admission/class_promote``);
  starvation bound  every jumped batch's hop counter is bumped; once a
                    batch reaches ``max_hops`` it becomes a barrier — no
                    later batch may hop it again, so perpetually
                    conflicting work always drains;
  signature bucket  disjointness tests run the one-word block-signature
                    certificate first (``plan.signatures_disjoint``):
                    disjoint-bucket pairs short-circuit before the
                    [R/64] word scan, so the O(window²) scan is
                    near-O(window) on striped traffic;
  exec chaining     epochs whose footprints are disjoint from EVERY
                    uncommitted predecessor dispatch exec immediately
                    against the same store snapshot — a dependency-DAG
                    chain up to ``max_inflight_execs`` deep (a 2-deep
                    overlap is the ``max_inflight_execs=2`` case);
                    the deferred commits then land in dispatch order with
                    explicit ts windows, so timestamps and watermark GC
                    are exactly the dispatch-order sequential schedule's;
  CC runs ahead     plans for up to ``max_inflight`` epochs are dispatched
                    while earlier execs are in flight (CC has no store
                    dependency);
  backpressure      at most ``max_inflight`` exec steps may be unrealised;
                    beyond that the oldest is joined before admitting more;
  snapshots         ``begin_snapshot`` first flushes the admission window
                    (so the pin covers every batch submitted so far) and
                    then pins the watermark; no epoch merges ACROSS a
                    pin, and hopped schedules only commute disjoint
                    batches, so the pinned snapshot reads exactly what
                    the submission-order schedule would expose.

Correctness model: a hop swaps only commuting batches, so per-ticket read
values and the head store equal the submission-order sequential schedule;
version begin/end timestamps in the rings follow the dispatch order, so
ring state is byte-identical to sequential ``run_batch`` calls in
``dispatch_log`` order (tests/test_torch_service.py holds the port to the
reference scheduler and to that oracle).

``reorder=False`` restores the FIFO-prefix merge (the benchmark
baseline); ``admission_window=1`` (default) degrades to the FIFO
pipelined schedule; ``pipelined=False`` additionally joins the host
after every epoch — the barriered baseline.

Port notes. PyTorch runs eagerly on the engine's stream, so "dispatch"
means enqueue: the phases return as soon as their work is queued (the
exec wavefront's per-wave exit test is its one host sync,
``core/execute.py``). Every join goes through ``repro_torch.device.fence``
(a stream synchronize on the card, nothing on the CPU), the counterpart
of the reference's ``block_until_ready``. Readiness for ``poll`` is a
``torch.cuda.Event`` recorded on the engine's stream after each epoch's
commit and kept beside the epoch's tickets; on the CPU a result is ready
at once. A batch's footprint is taken from the batch as submitted (one
host copy if it was built on the card, its own arrays on the CPU), and
the batch moves to the engine's device once, at admission. Deferred
commits read the store their exec was planned against, which is sound
because commits are functional: each builds new tensors and never
writes the previous store in place.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.engine import BohmEngine, SnapshotHandle
from repro_torch.core.plan import (MAX_BATCH_TXNS, BatchFootprint,
                                   batch_footprint, conflict_witness,
                                   footprints_conflict, merge_batches,
                                   merge_footprints)
from repro_torch.core.txn import TxnBatch
from repro_torch.obs import service_health
from repro_torch.obs.flight import NULL_FLIGHT, FlightRecorder
from repro_torch.store.ring import i32

# latency classes, lower scans first ("interactive" jumps "bulk")
LATENCY_CLASSES = {"interactive": 0, "bulk": 1}


def _popcount(bits) -> int:
    """Footprint cardinality (records touched) — traced-decision args
    only, never on the untraced hot path."""
    return int(np.unpackbits(np.asarray(bits).view(np.uint8)).sum())


@dataclasses.dataclass(frozen=True)
class BatchResult:
    """Realised (or in-flight) outputs of one submitted batch. For a
    batch that rode a merged CC epoch, ``read_vals`` is its own slice of
    the epoch's outputs and ``metrics`` are the EPOCH's metrics (waves,
    ring counters) — execution-fused batches share one wavefront."""
    ticket: int
    read_vals: torch.Tensor         # [T, Rd, D]
    metrics: Dict[str, torch.Tensor]


@dataclasses.dataclass
class _Admitted:
    ticket: int
    batch: TxnBatch
    footprint: Optional[BatchFootprint]
    latency_class: int = 1          # LATENCY_CLASSES rank
    hops: int = 0                   # times later batches jumped this one
    t_admit: float = 0.0            # monotonic admission time (health)


@dataclasses.dataclass
class _Planned:
    """One CC epoch: >= 1 admitted batches merged at admission time."""
    tickets: List[int]
    sizes: List[int]
    batch: TxnBatch                 # concatenated epoch batch
    footprint: Optional[BatchFootprint]
    plan: object                    # Plan (enqueued device work)
    ts_base: int
    watermark: int
    pin_ts: torch.Tensor            # registered pins at plan time

    @property
    def size(self) -> int:
        return sum(self.sizes)


class TxnService:
    def __init__(self, engine: BohmEngine, max_inflight: int = 2,
                 pipelined: bool = True, admission_window: int = 1,
                 reorder: bool = True, max_inflight_execs: int = 2,
                 max_hops: int = 4,
                 flight: Optional[FlightRecorder] = None):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if admission_window < 1:
            raise ValueError("admission_window must be >= 1")
        if max_inflight_execs < 1:
            raise ValueError("max_inflight_execs must be >= 1")
        if max_hops < 1:
            raise ValueError("max_hops must be >= 1")
        self.engine = engine
        self.max_inflight = max_inflight
        self.pipelined = pipelined
        self.admission_window = admission_window
        self.reorder = reorder
        self.max_inflight_execs = max_inflight_execs
        self.max_hops = max_hops
        self._next_ticket = 0
        self._admission: Deque[_Admitted] = deque()
        self._planned: Deque[_Planned] = deque()
        # unrealised exec steps: ONE entry (the epoch's ticket list) per
        # dispatched epoch — a merged epoch is a single exec step, so the
        # max_inflight bound counts epochs, not batches
        self._inflight: Deque[List[int]] = deque()
        self._results: Dict[int, BatchResult] = {}
        # per ticket: the event recorded on the engine's stream after its
        # epoch's commit (shared by the epoch's tickets; None on the CPU)
        self._ready: Dict[int, Optional[torch.cuda.Event]] = {}
        # epochs in dispatch (= timestamp) order, each a ticket list in
        # concatenation order: sequential run_batch calls in this order
        # reproduce the store byte-for-byte (the reordering oracle)
        self.dispatch_log: List[List[int]] = []
        # stats live in the engine's registry under the "service/"
        # namespace — same keys / same mutation sites as the legacy dict,
        # but visible to snapshot()/obs_report alongside engine counters
        self.metrics = engine.metrics
        self.tracer = engine.tracer
        # per-ticket lifecycle recorder (repro_torch.obs.flight). Default is
        # the shared disabled recorder, so every hook below reduces to
        # one attribute test — zero events, zero fences, byte-identical
        # results (property-tested next to the tracer's contract).
        self.flight = flight if flight is not None else NULL_FLIGHT
        if self.flight.enabled:
            self.flight.bind_registry(self.metrics)
        self.stats = engine.metrics.view("service/")
        for key in ("submitted", "planned_ahead_max",
                    "backpressure_joins",
                    # scheduler decisions (conflict-aware admission):
                    # merged_batches = batches folded into a preceding
                    # epoch; overlapped_execs = exec dispatched before a
                    # pending commit; hopped_batches = hop events (a
                    # queued batch jumped by a later one);
                    # class_promotions = interactive batches that jumped
                    # >= 1 earlier bulk batch; chain_depth_max = deepest
                    # exec chain dispatched against one store snapshot
                    "merged_batches", "overlapped_execs",
                    "hopped_batches", "class_promotions",
                    "chain_depth_max", "admission_window_occupancy"):
            self.stats[key] = 0

    @property
    def conflict_aware(self) -> bool:
        return self.admission_window > 1

    @property
    def out_of_order(self) -> bool:
        return self.reorder and self.conflict_aware

    # -- client API --------------------------------------------------------
    def submit(self, batch: TxnBatch,
               latency_class: Union[str, int] = "bulk") -> int:
        """Admit one update batch; returns a ticket for ``poll``/``wait``.
        Dispatch is non-blocking. With ``admission_window > 1`` a batch
        may be HELD in the admission queue until the window fills (or a
        flush point — poll/wait/drain/snapshot — arrives), trading a
        little admission latency for merge opportunities; an interactive
        batch anywhere in the queue disables the hold."""
        ticket = self._admit(batch, latency_class)
        self._pump()
        return ticket

    def submit_many(self, batches: Iterable[TxnBatch],
                    latency_class: Union[str, int] = "bulk") -> List[int]:
        """Admit a burst: everything is enqueued before the pump runs, so
        the window scan sees the full burst and the CC plan window fills
        to ``max_inflight`` ahead of the first exec join."""
        tickets = [self._admit(b, latency_class) for b in batches]
        self._pump()
        return tickets

    def _admit(self, batch: TxnBatch,
               latency_class: Union[str, int]) -> int:
        if batch.size > MAX_BATCH_TXNS:
            raise ValueError("composite uint32 keys require T <= 2^12")
        rank = LATENCY_CLASSES.get(latency_class, latency_class) \
            if isinstance(latency_class, str) else int(latency_class)
        if not isinstance(rank, int):
            raise ValueError(f"unknown latency_class {latency_class!r}")
        ticket = self._next_ticket
        self._next_ticket += 1
        fp = batch_footprint(batch, self.engine.num_records) \
            if self.conflict_aware else None
        batch = batch.to(self.engine.device)    # once, at admission
        self._admission.append(_Admitted(ticket, batch, fp, rank,
                                         t_admit=time.monotonic()))
        self.stats["submitted"] += 1
        if self.flight.enabled:
            self.flight.on_submit(ticket, rank, batch.size)
        return ticket

    def poll(self, ticket: int) -> Optional[BatchResult]:
        """Non-blocking: the result if that batch's outputs are realised
        on device, else None (still in flight). A result is handed out
        ONCE — retrieval consumes the ticket, so a long-running stream
        does not accumulate every historical batch's read values."""
        self._pump(flush=True)
        res = self._results.get(ticket)
        if res is None:
            return None
        if not _is_ready(self._ready.get(ticket)):
            return None
        self._note_joined(ticket)
        if self.flight.enabled:
            self.flight.on_visible(ticket)
        del self._results[ticket]
        self._ready.pop(ticket, None)
        return res

    def wait(self, ticket: int) -> BatchResult:
        """Block until the batch's outputs are realised. Like ``poll``,
        retrieval consumes the ticket."""
        self._pump(flush=True)
        res = self._results.pop(ticket)
        self._ready.pop(ticket, None)
        device_mod.fence(res.read_vals)
        self._note_joined(ticket)
        if self.flight.enabled:
            self.flight.on_visible(ticket)
        return res

    def drain(self) -> None:
        """Join everything in flight (the host-side batch barrier) and
        discard unretrieved results — a ticket must be waited/polled
        BEFORE the drain if its read values are wanted."""
        self._pump(flush=True)
        device_mod.fence(self.engine.store.base)
        if self.flight.enabled:
            # the store join above realised every outstanding commit, so
            # discarded results still complete their lifecycle records
            for ticket in self._results:
                self.flight.on_visible(ticket)
        self._inflight.clear()
        self._results.clear()
        self._ready.clear()

    def health(self) -> Dict[str, object]:
        """Engine MVCC health gauges plus scheduler queue depths, hop /
        promotion counters and max queued-ticket age (synchronises —
        diagnostic API)."""
        return service_health(self)

    # -- snapshot API (delegates to the engine; correctness notes) ---------
    def begin_snapshot(self, ts: Optional[int] = None) -> SnapshotHandle:
        """Pin a reader snapshot covering every batch submitted so far —
        identical to pinning between two sequential ``run_batch`` calls.
        The admission window is flushed first: held batches are planned
        (advancing the engine's plan-time timestamp mirror) so the pin
        lands after them, and no epoch ever merges ACROSS a pin — the
        pin is an epoch boundary, which keeps each epoch's plan-time
        watermark exactly the (dispatch-order) sequential schedule's."""
        self._pump(flush=True)
        return self.engine.begin_snapshot(ts)

    def release_snapshot(self, handle: SnapshotHandle) -> None:
        self.engine.release_snapshot(handle)

    def run_readonly_batch(self, batch: TxnBatch,
                           ts: Optional[int] = None):
        """Read-only batch against the (possibly still in-flight) store.
        Only a DEFAULT-ts read flushes the admission window (it must see
        every submitted batch); a read at an explicit ts or pinned handle
        cannot observe held batches — the resolve step's data dependency
        on the ring arrays already orders it after every dispatched
        commit, so merge chains keep accumulating under a progress-poll
        read loop and a pinned mid-window snapshot reads exactly the
        state it pinned."""
        self._pump(flush=ts is None)
        return self.engine.run_readonly_batch(batch, ts)

    # -- pump: form + plan ahead, chain execs, bound the queue -------------
    def _pump(self, flush: bool = False) -> None:
        """Interleaved dispatch: form epochs from the admission window and
        keep the plan window full, then dispatch the next exec chain.
        Everything here is non-blocking dispatch except the explicit
        barriered mode and backpressure joins. ``flush`` forces held
        batches through (flush points: poll/wait/drain/snapshot/readonly);
        without it, a not-yet-full admission window may hold batches back
        waiting for merge candidates."""
        while True:
            progressed = self._fill_plan_window(flush)
            if self._dispatch_chain():
                progressed = True
            # backpressure INSIDE the dispatch loop: a burst of submits
            # never enqueues more than max_inflight unrealised exec steps
            self._apply_backpressure()
            if not progressed:
                break

    def _apply_backpressure(self) -> None:
        """Bound the unrealised exec-step queue by joining the oldest
        epoch (any one of its results realises the whole step)."""
        while len(self._inflight) > self.max_inflight:
            oldest = self._inflight.popleft()
            for ticket in oldest:
                res = self._results.get(ticket)
                if res is not None:
                    device_mod.fence(res.read_vals)
                    self.stats["backpressure_joins"] += 1
                    break

    def _fill_plan_window(self, flush: bool = False) -> bool:
        """CC phase runs ahead: form + plan epochs for admitted batches
        while earlier exec steps are still in flight on the device
        queue. Timestamps are claimed per epoch in dispatch order — this
        is where a hopped schedule's tickets are renumbered."""
        eng = self.engine
        progressed = False
        while self._admission and len(self._planned) < self.max_inflight:
            if (self.conflict_aware and not flush
                    and len(self._admission) < self.admission_window
                    and not any(a.latency_class == 0
                                for a in self._admission)):
                break        # hold: wait for merge candidates
            tickets, sizes, batch, fp = self._pop_epoch()
            # the watermark (and pin set) the dispatch-order sequential
            # schedule would use for this epoch, captured at plan time
            # (the ts mirror equals this epoch's ts base here) so
            # pipelining cannot over-reclaim and spill admission sees
            # exactly the sequential pin set — byte-identical GC to the
            # barriered schedule. Pins created later land at >= the last
            # planned epoch's final ts, where they cannot stab anything
            # this epoch evicts, so missing them is safe (see
            # repro/store/ring.py liveness notes).
            wm = eng.watermark()
            pins = eng.pin_array()
            ts_base, _ = eng.claim_ts_window(batch.size)
            with self.tracer.span("plan_phase", txns=batch.size,
                                  epoch_batches=len(tickets)) as sp:
                plan = sp.fence(eng._plan(batch, i32(ts_base, eng.device)))
            self._planned.append(_Planned(tickets, sizes, batch, fp,
                                          plan, ts_base, wm, pins))
            self.dispatch_log.append(list(tickets))
            if self.flight.enabled:
                self.flight.on_dispatch(
                    tickets, epoch=len(self.dispatch_log) - 1,
                    epoch_txns=batch.size, epoch_batches=len(tickets))
            self.stats["planned_ahead_max"] = max(
                self.stats["planned_ahead_max"], len(self._planned))
            progressed = True
        return progressed

    # -- epoch formation ---------------------------------------------------
    def _pop_epoch(self):
        """Form the next CC epoch from the admission queue. Returns
        (tickets, sizes, batch, footprint) and removes the members."""
        self.stats["admission_window_occupancy"] = max(
            self.stats["admission_window_occupancy"],
            min(len(self._admission), self.admission_window))
        if self.out_of_order:
            return self._form_epoch_ooo()
        return self._form_epoch_fifo()

    def _form_epoch_fifo(self):
        """The FIFO-prefix merge (``reorder=False`` / baseline): start
        from the head, fold in each successor whose footprint is disjoint
        from the epoch built so far, stop at the first conflict (merging
        past it would reorder commits)."""
        head = self._admission.popleft()
        tickets, sizes = [head.ticket], [head.batch.size]
        batch, fp = head.batch, head.footprint
        member_fps = [(head.ticket, head.footprint)]
        scanned = 1
        while self._admission and scanned < self.admission_window:
            if not self._can_merge(batch, fp, self._admission[0]):
                if self.tracer.enabled and fp is not None:
                    nfp = self._admission[0].footprint
                    self.tracer.instant(
                        "admission_fallback",
                        epoch_batches=len(tickets),
                        epoch_records=_popcount(fp.rw_bits),
                        next_records=(_popcount(nfp.rw_bits)
                                      if nfp is not None else -1))
                if self.flight.enabled:
                    nxt = self._admission[0]
                    if nxt.footprint is not None:
                        for tk, mfp in member_fps:   # attribute the stop
                            w = conflict_witness(nxt.footprint, mfp)
                            if w is not None:
                                self.flight.on_blocked(
                                    nxt.ticket, "epoch-conflict", tk, w)
                                break
                break
            nxt = self._admission.popleft()
            batch = merge_batches(batch, nxt.batch)
            fp = merge_footprints(fp, nxt.footprint)
            member_fps.append((nxt.ticket, nxt.footprint))
            tickets.append(nxt.ticket)
            sizes.append(nxt.batch.size)
            self.stats["merged_batches"] += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "admission_merge",
                    epoch_batches=len(tickets),
                    merged_records=_popcount(nxt.footprint.rw_bits),
                    epoch_records=_popcount(fp.rw_bits))
            scanned += 1
        return tickets, sizes, batch, fp

    def _form_epoch_ooo(self):
        """Out-of-order epoch formation over the admission window.

        Selection invariant: a batch may join the epoch only if it (a)
        commutes with the epoch built so far (merge condition), and (b)
        commutes with EVERY earlier-submitted batch left in the queue
        (hop condition) — so the dispatched schedule only ever swaps
        commuting batches and per-ticket outputs stay byte-identical to
        submission order. A queued batch with ``hops >= max_hops`` is a
        barrier: nothing may hop it, so it seeds one of the next epochs
        (starvation bound). Scan priority: interactive class first, then
        submission order — the objective is the WIDEST legal epoch
        (dispatch count dominates chain overlap on every measured
        stream), so selection is a greedy multi-pass fixpoint."""
        adm = self._admission
        window = [adm[i] for i in range(min(len(adm),
                                           self.admission_window))]
        n = len(window)
        fps = [a.footprint for a in window]
        order = sorted(range(n),
                       key=lambda i: (window[i].latency_class, i))
        sel: List[int] = []          # selected window positions
        sel_set: set = set()
        ef: Optional[BatchFootprint] = None
        epoch_size = 0
        changed = True
        while changed:               # multi-pass: a selection can unblock
            changed = False          # candidates behind a barrier
            for i in order:
                if i in sel_set:
                    continue
                a = window[i]
                if sel:
                    head = window[sel[0]]
                    if not self._widths_match(head.batch, a.batch):
                        continue
                    if epoch_size + a.batch.size > MAX_BATCH_TXNS:
                        continue
                    # disjointness tests run the one-word signature
                    # certificate first (plan.signatures_disjoint) —
                    # disjoint-bucket pairs never touch the word scan
                    if footprints_conflict(ef, a.footprint):
                        continue
                # hop condition: commutes with every earlier-submitted
                # batch left behind, none of which is hop-saturated
                legal = True
                for j in range(i):
                    if j in sel_set:
                        continue
                    if (window[j].hops >= self.max_hops
                            or footprints_conflict(a.footprint, fps[j])):
                        legal = False
                        break
                if not legal:
                    continue
                sel.append(i)
                sel_set.add(i)
                ef = a.footprint if ef is None \
                    else merge_footprints(ef, a.footprint)
                epoch_size += a.batch.size
                changed = True
        sel.sort()   # concatenate members in submission order
        if self.flight.enabled and sel:
            # attribution BEFORE the hop bump, so recorded reasons match
            # the hop/saturation state the selection loop actually saw
            self._attribute_blocks(window, fps, sel, sel_set)
        # hop + class-promotion accounting for everything jumped over
        jumped = [j for j in range(max(sel))
                  if j not in sel_set] if sel else []
        for j in jumped:
            window[j].hops += 1
            if self.flight.enabled:
                self.flight.on_hop(window[j].ticket, window[j].hops)
                if window[j].hops >= self.max_hops:
                    self.flight.on_saturate(window[j].ticket)
        if jumped:
            self.stats["hopped_batches"] += len(jumped)
            if self.tracer.enabled:
                self.tracer.instant(
                    "admission/hop", jumped=len(jumped),
                    epoch_batches=len(sel),
                    max_hops_queued=max(window[j].hops for j in jumped))
            promos = sum(
                1 for i in sel if window[i].latency_class == 0
                and any(j < i and window[j].latency_class > 0
                        for j in jumped))
            if promos:
                self.stats["class_promotions"] += promos
                if self.tracer.enabled:
                    self.tracer.instant("admission/class_promote",
                                        promoted=promos,
                                        jumped=len(jumped))
        # build the epoch and drop members from the queue
        members = [window[i] for i in sel]
        head, rest = members[0], members[1:]
        tickets, sizes = [head.ticket], [head.batch.size]
        batch, fp = head.batch, head.footprint
        for m in rest:
            batch = merge_batches(batch, m.batch)
            fp = merge_footprints(fp, m.footprint)
            tickets.append(m.ticket)
            sizes.append(m.batch.size)
            self.stats["merged_batches"] += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "admission_merge",
                    epoch_batches=len(tickets),
                    merged_records=_popcount(m.footprint.rw_bits),
                    epoch_records=_popcount(fp.rw_bits))
        self._admission = deque(
            [adm[i] for i in range(len(adm)) if i not in sel_set])
        return tickets, sizes, batch, fp

    def _attribute_blocks(self, window, fps, sel, sel_set) -> None:
        """Flight-recorder conflict attribution (enabled-only path): for
        every window member NOT selected into the epoch, identify the
        blocker the selection checks tripped on — a selected member
        whose footprint conflicts (the candidate was hopped over:
        ``epoch-conflict``), an earlier unselected batch it cannot
        legally hop (``hop-blocked``), or a hop-saturated barrier
        (``hop-saturated``) — plus a concrete witness record from
        ``plan.conflict_witness``. One event per member per formation
        round, mirroring the selection checks in their evaluation
        order."""
        fl = self.flight
        for i in range(len(window)):
            if i in sel_set:
                continue
            a = window[i]
            if a.footprint is None:
                continue
            for s in sel:                      # merge condition first
                w = conflict_witness(a.footprint, fps[s])
                if w is not None:
                    fl.on_blocked(a.ticket, "epoch-conflict",
                                  window[s].ticket, w)
                    break
            else:                              # then the hop condition
                for j in range(i):
                    if j in sel_set:
                        continue
                    if window[j].hops >= self.max_hops:
                        fl.on_blocked(
                            a.ticket, "hop-saturated", window[j].ticket,
                            conflict_witness(a.footprint, fps[j]))
                        break
                    w = conflict_witness(a.footprint, fps[j])
                    if w is not None:
                        fl.on_blocked(a.ticket, "hop-blocked",
                                      window[j].ticket, w)
                        break

    @staticmethod
    def _widths_match(a: TxnBatch, b: TxnBatch) -> bool:
        return (a.n_read, a.n_write, a.args.shape[1:]) == \
            (b.n_read, b.n_write, b.args.shape[1:])

    @classmethod
    def _can_merge(cls, batch: TxnBatch, fp: Optional[BatchFootprint],
                   nxt: _Admitted) -> bool:
        if fp is None or nxt.footprint is None:
            return False
        if not cls._widths_match(batch, nxt.batch):
            return False
        if batch.size + nxt.batch.size > MAX_BATCH_TXNS:
            return False
        return not footprints_conflict(fp, nxt.footprint)

    # -- exec + commit -----------------------------------------------------
    def _dispatch_chain(self) -> bool:
        """Execution in dispatch order: each commit consumes the previous
        commit's store (the batch barrier as a device data dependency) —
        but an epoch whose footprint is disjoint from ALL uncommitted
        predecessors dispatches exec against the same store snapshot
        BEFORE those commits land: a dependency-DAG chain bounded by
        ``max_inflight_execs``. The deferred commits then land in
        dispatch order with their plan-time watermarks and ts windows,
        byte-identical to the barriered (dispatch-order) schedule."""
        if not self._planned:
            return False
        e1 = self._planned.popleft()
        chain = [(e1, self._exec_epoch(e1))]
        chain_fp = e1.footprint
        while (self.pipelined and self.conflict_aware and self._planned
               and len(chain) < self.max_inflight_execs
               and chain_fp is not None
               and self._planned[0].footprint is not None
               and not footprints_conflict(chain_fp,
                                           self._planned[0].footprint)):
            e = self._planned.popleft()
            chain.append((e, self._exec_epoch(e, overlapped=True,
                                              chain_depth=len(chain) + 1)))
            chain_fp = merge_footprints(chain_fp, e.footprint)
            self.stats["overlapped_execs"] += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "admission_overlap",
                    epoch1_txns=e1.size, epoch2_txns=e.size,
                    chain_depth=len(chain),
                    epoch_records=_popcount(e.footprint.rw_bits))
        if len(chain) > 1:
            self.stats["chain_depth_max"] = max(
                self.stats["chain_depth_max"], len(chain))
            if self.tracer.enabled:
                self.tracer.instant(
                    "admission/chain_depth", depth=len(chain),
                    txns=sum(e.size for e, _ in chain))
        for e, (w, r, m) in chain:
            self._commit_epoch(e, w, r, m)
        return True

    def _exec_epoch(self, e: _Planned, overlapped: bool = False,
                    chain_depth: int = 1):
        kwargs = {"overlapped": True} if overlapped else {}
        with self.tracer.span("exec_phase", txns=e.size, **kwargs) as sp:
            w, r, m = self.engine._exec(e.plan, e.batch, self.engine.store)
            sp.fence(r)
        if self.flight.enabled:
            self.flight.on_exec(e.tickets, chain_depth)
        return w, r, m

    def _commit_epoch(self, e: _Planned, w_data, read_vals,
                      exec_metrics) -> None:
        """Deferred-commit half of an epoch: explicit ts window so the
        store's timestamp accounting is exactly sequential (in dispatch
        order), then fan the epoch outputs back out to per-ticket
        results."""
        eng = self.engine
        dev = eng.device
        window = (i32(e.ts_base, dev), i32(e.ts_base + e.size, dev))
        with self.tracer.span("commit_phase", txns=e.size,
                              epoch_batches=len(e.tickets)) as sp:
            store, ring_metrics = eng._commit(
                e.plan, e.batch, eng.store, w_data,
                i32(e.watermark, dev), window, e.pin_ts)
            eng.store = store
            sp.fence(store.base)
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        if self.flight.enabled:
            self.flight.on_commit(e.tickets)
        metrics = dict(exec_metrics, **ring_metrics)
        eng.record_commit_metrics(metrics, n_txns=e.size)
        off = 0
        for ticket, size in zip(e.tickets, e.sizes):
            rv = read_vals if len(e.tickets) == 1 \
                else read_vals[off:off + size]
            self._results[ticket] = BatchResult(ticket, rv, metrics)
            self._ready[ticket] = ready
            off += size
        self._inflight.append(list(e.tickets))
        if not self.pipelined:
            device_mod.fence(store.base)
            self._inflight.clear()

    def _note_joined(self, ticket: int) -> None:
        """A realised ticket realises its whole epoch's exec step."""
        for i, epoch_tickets in enumerate(self._inflight):
            if ticket in epoch_tickets:
                del self._inflight[i]
                return


def _is_ready(event: Optional[torch.cuda.Event]) -> bool:
    """Has the stream passed the epoch's commit? (A CPU result, recorded
    without an event, is ready at once.)"""
    return event is None or bool(event.query())
