"""FlightRecorder: per-ticket lifecycle tracing for the OOO scheduler
(port of ``repro.obs.flight``, a copy minus ``stitch_chrome_trace``).

The phase tracer (``repro_torch.obs.PhaseTracer``) answers "how long do
plan / exec / commit take"; after out-of-order admission that is not
enough to answer "why did THIS ticket take 70ms" — queue wait behind a
conflicting burst? hop-blocked by a hop-saturated barrier batch? chained
behind an uncommitted epoch? deferred commit? The flight recorder gives every
submitted ticket a bounded lifecycle record:

  submit ─ queue ─→ dispatch (epoch join) ─ formation ─→ exec
         ─ exec ─→ commit (deferred) ─ commit_defer ─→ visible

with monotonic host stamps at each transition. The derived breakdown
(``queue`` / ``formation`` / ``exec`` / ``commit_defer``) telescopes, so
the components sum to the end-to-end latency EXACTLY — a breakdown that
doesn't add up is a lifecycle bug, and the tests treat it as one.

Zero-sync contract (same as the tracer, property-tested with it):

  * every stamp is a host ``perf_counter`` read at a lifecycle
    transition the scheduler already executes — the recorder NEVER calls
    ``repro_torch.device.fence``; the ``visible`` stamp rides the join
    that ``poll``/``wait``/``drain`` already perform;
  * disabled (the default), every hook is a single attribute test:
    zero events, zero fences, byte-identical engine results.

Conflict attribution: when the scheduler declines a batch — it conflicts
with the epoch under formation, fails the hop condition against an
earlier-submitted batch, or is stuck behind a hop-saturated barrier —
the recorder stores (kind, blocker ticket, witness record) on the
blocked ticket, where the witness comes from
``repro_torch.core.plan.conflict_witness`` (a record provably written
by one side and touched by the other). Witness counts aggregate into a top-K
"blocking records" heatmap, exposed as a registry gauge: the records
that cost the most reordering show up by name.

Export: ``to_async_events`` renders each completed ticket as a Chrome
``trace_event`` *nestable async* lane (``ph`` b/n/e, ``cat="flight"``,
``id`` = ticket) — one horizontal lane per ticket with its four phase
slices and blocked-instant markers. Stitching the lanes into a
``PhaseTracer`` Chrome export (``stitch_chrome_trace``) waits for the
tracer's event ring and export (ROADMAP.md, queue 1, slice E).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.quantiles import LogHistogram

_US = 1e6

# lifecycle phases in order; breakdown keys (seconds)
PHASES = ("queue", "formation", "exec", "commit_defer")

# attribution kinds (see TxnService epoch formation)
BLOCK_KINDS = ("epoch-conflict", "hop-blocked", "hop-saturated")

_MAX_BLOCK_EVENTS = 8       # per-ticket attribution ring


@dataclasses.dataclass
class TicketFlight:
    """One ticket's lifecycle record (host-side, bounded)."""
    ticket: int
    latency_class: int
    n_txns: int
    t_submit: float
    t_dispatch: Optional[float] = None   # joined an epoch, plan dispatched
    t_exec: Optional[float] = None       # exec dispatched (chain position)
    t_commit: Optional[float] = None     # deferred commit dispatched
    t_visible: Optional[float] = None    # outputs realised on host
    epoch: int = -1                      # dispatch-order epoch index
    epoch_txns: int = 0
    epoch_batches: int = 0
    chain_depth: int = 0                 # position in the exec chain (1 =
    #                                      head, >1 = ran pre-commit)
    hops: int = 0                        # times later batches jumped this
    saturated: bool = False              # hit max_hops -> barrier
    # (t, kind, blocker_ticket, witness_record); bounded ring
    blocked: List[Tuple[float, str, int, int]] = \
        dataclasses.field(default_factory=list)
    blocked_dropped: int = 0

    @property
    def complete(self) -> bool:
        return self.t_visible is not None

    def breakdown(self) -> Dict[str, float]:
        """Latency components (seconds). Telescoping differences of the
        four stamps, so ``sum(components) == total`` exactly."""
        out = {
            "queue": self.t_dispatch - self.t_submit,
            "formation": self.t_exec - self.t_dispatch,
            "exec": self.t_commit - self.t_exec,
            "commit_defer": self.t_visible - self.t_commit,
        }
        out["total"] = self.t_visible - self.t_submit
        return out


class FlightRecorder:
    """Bounded per-ticket lifecycle recorder (see module docstring).

    ``capacity`` bounds the COMPLETED-ticket ring (oldest dropped first,
    counted in ``dropped``); in-flight tickets are tracked exactly —
    the scheduler's own backpressure bounds how many exist at once."""

    def __init__(self, capacity: int = 4096, enabled: bool = False,
                 top_k: int = 8,
                 digest_lo: float = 1e-5, digest_growth: float = 2 ** 0.125,
                 digest_buckets: int = 192):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = enabled
        self.capacity = capacity
        self.top_k = top_k
        self._digest_kw = dict(lo=digest_lo, growth=digest_growth,
                               n_buckets=digest_buckets)
        self._clock = time.perf_counter
        self._live: Dict[int, TicketFlight] = {}
        self._done: deque = deque(maxlen=capacity)
        self.dropped = 0
        # conflict-attribution aggregates
        self.blocking_records: Counter = Counter()   # witness -> count
        self.blocking_tickets: Counter = Counter()   # blocker -> count
        self.block_kinds: Counter = Counter()        # kind -> count
        # per-latency-class end-to-end digests (class rank -> digest)
        self.digests: Dict[int, LogHistogram] = {}
        self.completed = 0

    # -- lifecycle hooks (all no-ops when disabled) ------------------------
    def on_submit(self, ticket: int, latency_class: int,
                  n_txns: int) -> None:
        if not self.enabled:
            return
        self._live[ticket] = TicketFlight(ticket, latency_class, n_txns,
                                          t_submit=self._clock())

    def on_dispatch(self, tickets: Iterable[int], epoch: int,
                    epoch_txns: int, epoch_batches: int) -> None:
        """The epoch-join transition: these tickets left the admission
        queue together and their merged plan is on the device queue."""
        if not self.enabled:
            return
        t = self._clock()
        for tk in tickets:
            f = self._live.get(tk)
            if f is not None:
                f.t_dispatch = t
                f.epoch = epoch
                f.epoch_txns = epoch_txns
                f.epoch_batches = epoch_batches

    def on_exec(self, tickets: Iterable[int], chain_depth: int = 1) -> None:
        if not self.enabled:
            return
        t = self._clock()
        for tk in tickets:
            f = self._live.get(tk)
            if f is not None:
                f.t_exec = t
                f.chain_depth = chain_depth

    def on_commit(self, tickets: Iterable[int]) -> None:
        if not self.enabled:
            return
        t = self._clock()
        for tk in tickets:
            f = self._live.get(tk)
            if f is not None:
                f.t_commit = t

    def on_visible(self, ticket: int) -> None:
        """The ticket's outputs are realised on the host (the caller just
        joined them — poll/wait/drain). Completes the record."""
        if not self.enabled:
            return
        f = self._live.pop(ticket, None)
        if f is None or f.t_commit is None:
            return
        f.t_visible = self._clock()
        if len(self._done) == self.capacity:
            self.dropped += 1
        self._done.append(f)
        self.completed += 1
        digest = self.digests.get(f.latency_class)
        if digest is None:
            digest = self.digests[f.latency_class] = LogHistogram(
                **self._digest_kw)
        digest.add(f.t_visible - f.t_submit)

    def on_blocked(self, ticket: int, kind: str, blocker: int,
                   witness: Optional[int]) -> None:
        """Attribution: ``ticket`` stayed queued because of ``blocker``;
        ``witness`` is the overlapping record (None only when the
        blocker is a hop-saturated barrier the candidate commutes
        with)."""
        if not self.enabled:
            return
        self.block_kinds[kind] += 1
        self.blocking_tickets[blocker] += 1
        if witness is not None:
            self.blocking_records[witness] += 1
        f = self._live.get(ticket)
        if f is None:
            return
        if len(f.blocked) >= _MAX_BLOCK_EVENTS:
            f.blocked_dropped += 1
            return
        f.blocked.append((self._clock(), kind, blocker,
                          -1 if witness is None else witness))

    def on_hop(self, ticket: int, hops: int) -> None:
        if not self.enabled:
            return
        f = self._live.get(ticket)
        if f is not None:
            f.hops = hops

    def on_saturate(self, ticket: int) -> None:
        if not self.enabled:
            return
        f = self._live.get(ticket)
        if f is not None:
            f.saturated = True

    # -- reads -------------------------------------------------------------
    def records(self) -> List[TicketFlight]:
        """Completed ticket records, oldest first (bounded ring)."""
        return list(self._done)

    def inflight(self) -> int:
        return len(self._live)

    def blocking_top(self, k: Optional[int] = None
                     ) -> List[Tuple[int, int]]:
        """Top-K (record, block-count) heatmap — the records that cost
        the scheduler the most reordering decisions."""
        return self.blocking_records.most_common(k or self.top_k)

    def class_quantiles(self, qs=(50.0, 99.0)
                        ) -> Dict[int, Dict[str, float]]:
        """Per-latency-class end-to-end quantiles in SECONDS:
        ``{class_rank: {"p50": ..., "p99": ..., "count": ...}}``."""
        out = {}
        for rank, digest in sorted(self.digests.items()):
            row = {f"p{q:g}": digest.quantile(q) for q in qs}
            row["count"] = digest.count
            row["mean"] = digest.mean
            out[rank] = row
        return out

    def bind_registry(self, registry) -> None:
        """Expose the recorder's aggregates as registry gauges (evaluated
        only at ``snapshot()`` — nothing on the hot path)."""
        registry.register_gauge("flight/completed", lambda: self.completed)
        registry.register_gauge("flight/inflight", self.inflight)
        registry.register_gauge("flight/dropped", lambda: self.dropped)
        registry.register_gauge("flight/blocking_records_topk",
                                self.blocking_top)
        registry.register_gauge(
            "flight/block_kinds", lambda: dict(self.block_kinds))

    def clear(self) -> None:
        self._live.clear()
        self._done.clear()
        self.dropped = 0
        self.completed = 0
        self.blocking_records.clear()
        self.blocking_tickets.clear()
        self.block_kinds.clear()
        self.digests.clear()

    # -- Chrome-trace async lanes ------------------------------------------
    def earliest_ts(self) -> Optional[float]:
        stamps = [f.t_submit for f in self._done]
        stamps += [f.t_submit for f in self._live.values()]
        return min(stamps) if stamps else None

    def to_async_events(self, t0: float, pid: int = 0) -> List[Dict]:
        """Chrome nestable-async events (``ph`` b/n/e) for every COMPLETED
        ticket: one lane per ticket (``cat="flight"``, ``id`` = ticket),
        the four phase slices nested inside a whole-ticket slice, and an
        ``n`` marker per attribution event. Timestamps are microseconds
        since ``t0`` (the caller's shared epoch)."""
        events: List[Dict] = []

        def ev(ph, name, t, tk, **args):
            e = {"name": name, "ph": ph, "ts": round((t - t0) * _US, 3),
                 "pid": pid, "tid": 0, "cat": "flight", "id": str(tk)}
            if args:
                e["args"] = args
            events.append(e)

        for f in self._done:
            bd = f.breakdown()
            ev("b", "ticket", f.t_submit, f.ticket,
               latency_class=f.latency_class, txns=f.n_txns,
               epoch=f.epoch, epoch_batches=f.epoch_batches,
               chain_depth=f.chain_depth, hops=f.hops,
               saturated=f.saturated)
            stamps = (f.t_submit, f.t_dispatch, f.t_exec, f.t_commit,
                      f.t_visible)
            for i, phase in enumerate(PHASES):
                ev("b", phase, stamps[i], f.ticket)
                ev("e", phase, stamps[i + 1], f.ticket)
            for t, kind, blocker, witness in f.blocked:
                ev("n", "blocked", t, f.ticket, kind=kind,
                   blocker=blocker, witness=witness)
            ev("e", "ticket", f.t_visible, f.ticket,
               **{f"{k}_ms": round(v * 1e3, 4) for k, v in bd.items()})
        # lanes are generated per ticket; the validator (and Perfetto)
        # want global ts order — the sort is stable, so each lane's
        # b/n/e generation order survives
        events.sort(key=lambda e: e["ts"])
        return events


#: shared disabled recorder — the scheduler's default, so every hook is a
#: single attribute test on the hot path (mirrors ``obs.NULL_SPAN``)
NULL_FLIGHT = FlightRecorder(capacity=1, enabled=False)
