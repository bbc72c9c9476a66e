"""BohmEngine: the two-phase batch pipeline, single-device port.

The port of ``repro.core.engine``: ``run_batch`` runs plan -> wavefront
execute -> watermark commit (three phase functions, as in the reference's
phase graph), snapshot pins hold the GC watermark down, and read-only
transactions resolve visibility through the hand-written CUDA kernels
(``mvcc_resolve`` over the dense primary ring or ``mvcc_resolve_paged``
over the page slab, ``mvcc_resolve_masked`` over the spill tier) with no
CC phase and no writes to shared state. With ``adaptive_k`` each
``gc_sweep`` also runs the host-side ``reassign_k`` policy, which moves
primary capacity from cold records to hot ones (at page granularity for
the paged store).

PyTorch runs eagerly, so there are no jits: the phase functions are plain
functions on tensors, and work is enqueued on the current CUDA stream
without host syncs except the wavefront's per-wave exit test and the
diagnostic stats surfaces.

``n_shards > 1`` partitions the store into logical shards on the one
device (global record ``r`` at shard ``r % n``, local ``r // n``), as
the reference's no-mesh substrate does.

The phase functions are also bound on the engine as ``_plan``, ``_exec``
(workload bound) and ``_commit``, with the reference's argument order,
and their composition as ``_step`` (``bohm_step``, which leaves the
engine's store as it was);
the scheduler (``repro_torch.service.TxnService``) calls them with its
own interleaving. ``health()`` reads the MVCC gauges
(``repro_torch.obs.health``). An enabled ``PhaseTracer`` records the
phases as spans (``repro_torch.obs.trace``); an enabled
``LifecycleAuditor`` makes every commit emit the audit arrays, runs the
audited sweep in ``gc_sweep`` and harvests at ``gc_sweep`` /
``snapshot()`` (``repro_torch.obs.lifecycle``), with no host join added
between them.

Not ported yet (raises ``NotImplementedError``): ``mesh=`` (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.carry import store_from_reference
from repro_torch.core.execute import (Store, commit, execute_plan,
                                      init_store, store_from_base)
from repro_torch.core.plan import MAX_BATCH_TXNS, Plan, cc_plan
from repro_torch.core.txn import TxnBatch, Workload
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import (NULL_AUDIT, LifecycleAuditor, MetricsRegistry,
                             PhaseTracer, engine_health)
from repro_torch.store import (INF_TS, decay_pressure, from_global,
                               gather_windows_sharded, gc_sharded,
                               gc_sharded_audited,
                               reassign_k, reassign_stats, resolve_sharded,
                               store_occupancy, to_global)
from repro_torch.store.ring import i32


@dataclasses.dataclass(frozen=True)
class SnapshotHandle:
    """An active reader registration; holds the GC watermark at <= ts.
    ``t_wall`` (monotonic registration time) feeds the oldest-pin-age
    health gauge; it takes no part in equality."""
    sid: int
    ts: int
    t_wall: float = dataclasses.field(default=0.0, compare=False)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"BohmEngine({what}) is not ported yet: repro_torch runs the "
        "single-device engine with logical shards (ROADMAP.md, queue 1)")


class BohmEngine:
    def __init__(self, num_records: int, workload: Workload,
                 mesh=None, ring_slots: int = 4,
                 n_shards: Optional[int] = None,
                 spill_buckets: Optional[int] = None,
                 spill_slots: int = 8,
                 adaptive_k: bool = False, k_min: int = 1,
                 k_max: Optional[int] = None,
                 paged: bool = False, page_slots: int = 4,
                 pages_per_shard: Optional[int] = None,
                 pressure_decay: Optional[float] = None,
                 k_quantum: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[PhaseTracer] = None,
                 auditor: Optional[LifecycleAuditor] = None,
                 device: DeviceLike = None):
        """Arguments as in ``repro.core.engine.BohmEngine`` (``mesh``,
        the unported path, raises), plus
        ``device``: default the GPU, which
        raises when there is none; pass ``device="cpu"`` for the plain
        PyTorch path.

        ``n_shards`` (default 1) logical shards each hold ``ceil(R /
        n_shards)`` records. ``spill_slots`` > 0 (default 8) attaches a
        spill pool per shard of ``spill_buckets`` (default: one bucket per
        4 records of a shard) x ``spill_slots`` slots.
        ``adaptive_k=True`` allocates rings at ``k_max`` physical slots
        (default 2x ``ring_slots``), caps every record at ``ring_slots``
        effective slots, and lets ``gc_sweep`` move capacity between
        records within the budget R x ``ring_slots``. ``paged=True``
        swaps the dense rings for the page slab: ``pages_per_shard``
        pages (default ``ceil(ring_slots / page_slots)`` per record of a
        shard) of ``page_slots`` slots, reads through the
        ``mvcc_resolve_paged`` kernel; adaptive paged stores need
        ``ring_slots`` and ``k_max`` to be page multiples.
        ``pressure_decay`` (sweeps) applies an EWMA half-life to the
        policy's pressure input; ``k_quantum`` overrides the policy
        quantum (default ``page_slots`` when paged, else 1)."""
        if mesh is not None:
            raise _unported("mesh=")
        if num_records > (1 << 20):
            raise ValueError("composite uint32 keys require R <= 2^20")
        if ring_slots < 1:
            raise ValueError("ring_slots must be >= 1")
        self.device = resolve_device(device)
        self.num_records = num_records
        self.workload = workload
        self.ring_slots = ring_slots
        self.adaptive_k = bool(adaptive_k)
        self.k_min = int(k_min)
        self.k_max = int(k_max if k_max is not None
                         else (2 * ring_slots if adaptive_k
                               else ring_slots))
        if self.k_max < ring_slots:
            raise ValueError("k_max must be >= ring_slots")
        if not 1 <= self.k_min <= ring_slots:
            raise ValueError("k_min must be in [1, ring_slots] (k_eff "
                             "starts at ring_slots)")
        self.paged = bool(paged)
        self.page_slots = int(page_slots) if self.paged else 0
        self.k_quantum = int(k_quantum) if k_quantum is not None else (
            self.page_slots if self.paged else 1)
        if self.adaptive_k and self.k_quantum > 1:
            if ring_slots % self.k_quantum or self.k_max % self.k_quantum:
                raise ValueError(
                    "page-quantized adaptive K requires ring_slots and "
                    "k_max to be multiples of the quantum (page_slots)")
        self.pressure_decay = (float(pressure_decay)
                               if pressure_decay is not None else None)
        self.n_shards = int(n_shards) if n_shards is not None else 1
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        records_local = -(-num_records // self.n_shards)
        self.pages_per_shard = 0
        if self.paged:
            # default: every record can physically reach its initial
            # k_eff — ceil(ring_slots / S) pages each
            self.pages_per_shard = int(
                pages_per_shard if pages_per_shard is not None
                else records_local * -(-ring_slots // self.page_slots))
        self.spill_slots = int(spill_slots)
        self.spill_buckets = int(spill_buckets if spill_buckets is not None
                                 else max(1, records_local // 4)
                                 ) if self.spill_slots > 0 else 0
        self.store = init_store(num_records, workload.payload_words,
                                ring_slots=self.k_max,
                                n_shards=self.n_shards,
                                spill_buckets=self.spill_buckets,
                                spill_slots=self.spill_slots,
                                k_init=ring_slots, paged=self.paged,
                                page_slots=self.page_slots or 4,
                                pages_per_shard=self.pages_per_shard
                                or None, device=self.device)
        self._ts_next = 1                  # host mirror of store.ts_counter
        self._snapshots: Dict[int, SnapshotHandle] = {}
        self._next_sid = 0
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else PhaseTracer(enabled=False)
        self.auditor = auditor if auditor is not None else NULL_AUDIT
        self._declare_metrics()
        self._reset_policy()
        # the phase graph, bound as in the reference (the scheduler calls
        # the same three with its own interleaving)
        self._plan = plan_phase
        self._exec = functools.partial(exec_phase, workload=workload)
        self._commit = functools.partial(commit_phase,
                                         with_audit=self.auditor.enabled)
        self._step = functools.partial(bohm_step, workload=workload)

    def _reset_policy(self) -> None:
        """Restart the adaptive-K policy's host state (at init,
        ``reset_store`` and ``load_state``): the hysteresis mask (a record
        donates only after two consecutive idle sweeps), the commits since
        the last sweep, and the EWMA pressure state (the decayed
        accumulator and the cumulative histogram at the last sweep)."""
        R = self.num_records
        self._stable_idle = np.zeros((R,), bool)
        self._commits_since_sweep = 0
        self._pressure_ewma = np.zeros((R,), np.float64)
        self._overflow_at_sweep = np.zeros((R,), np.int64)

    _SPILL_KEYS = ("spill_admitted", "spill_dropped",
                   "spill_overwrote_pinned")

    def _declare_metrics(self) -> None:
        """(Re)declare the engine's device counters (run at init, at
        ``reset_store`` and at ``load_state``)."""
        m = self.metrics
        k_eff = self.store.versions.k_eff
        scalar = torch.zeros((), dtype=torch.int32, device=self.device)
        m.declare("engine/ring_overwrote_rec", k_eff)
        m.declare("engine/ring_overwrote_dead_rec", k_eff)
        for name in ("ring_overwrote_live", "ring_overwrote_dead",
                     "paged_alloc_failed", "aborts", "waves",
                     *self._SPILL_KEYS):
            m.declare(f"engine/{name}", scalar)
        m.set("engine/commits", 0)
        m.set("engine/txns_committed", 0)
        if self.auditor.enabled:
            # lifecycle counters share the store's lifecycle too
            self.auditor.bind_engine(self)

    # -- update path -------------------------------------------------------
    def run_batch(self, batch: TxnBatch
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One batch through the phase graph: plan -> exec -> commit."""
        if batch.size > MAX_BATCH_TXNS:
            raise ValueError("composite uint32 keys require T <= 2^12")
        batch = batch.to(self.device)
        tr = self.tracer
        wm = i32(self.watermark(), self.device)
        pins = self.pin_array()
        with tr.span("plan_phase", txns=batch.size) as sp:
            plan = sp.fence(self._plan(batch, self.store.ts_counter))
        with tr.span("exec_phase", txns=batch.size) as sp:
            w_data, read_vals, exec_metrics = self._exec(plan, batch,
                                                         self.store)
            sp.fence(read_vals)
        with tr.span("commit_phase", txns=batch.size) as sp:
            self.store, ring_metrics = self._commit(
                plan, batch, self.store, w_data, wm, None, pins)
            sp.fence(self.store.base)
        metrics = dict(exec_metrics, **ring_metrics)
        self.claim_ts_window(batch.size)
        self.record_commit_metrics(metrics, n_txns=batch.size)
        return read_vals, metrics

    def run_stream(self, batches) -> Dict[str, torch.Tensor]:
        """Run batches back to back; only the wavefront's exit tests join
        the host. Returns the metrics of the final batch."""
        metrics = None
        for batch in batches:
            _, metrics = self.run_batch(batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return metrics

    def snapshot(self) -> torch.Tensor:
        if self.auditor.enabled:
            self.auditor.harvest()
        return self.store.base

    def reset_store(self, base: torch.Tensor,
                    base_ts: Optional[torch.Tensor] = None) -> None:
        """Reinitialise committed state (head cache + primary + spill)
        from ``base``; the device counters and the policy's host state
        restart too."""
        self.store = store_from_base(
            torch.as_tensor(base).to(self.device),
            None if base_ts is None
            else torch.as_tensor(base_ts).to(self.device),
            self.k_max, n_shards=self.n_shards,
            spill_buckets=self.spill_buckets,
            spill_slots=self.spill_slots, k_init=self.ring_slots,
            paged=self.paged, page_slots=self.page_slots or 4,
            pages_per_shard=self.pages_per_shard or None)
        self._ts_next = 1
        self._snapshots.clear()
        self._declare_metrics()
        self._reset_policy()

    def load_state(self, arrays: Dict[str, np.ndarray], ts_next: int,
                   pins: Iterable[int] = ()) -> List[SnapshotHandle]:
        """Adopt committed state carried across from another engine (the
        numpy dict of ``repro_torch.core.carry``): the store, the next
        timestamp to assign and the registered snapshot pins. The state's
        layout (dense or paged, its shapes) must be this engine's. Device
        counters and the adaptive-K policy's host state restart, as in
        ``reset_store``. Returns the new pins' handles."""
        store = store_from_reference(arrays, self.device)
        if _layout(store) != _layout(self.store):
            raise ValueError("carried state does not match this engine's "
                             f"configuration: {_layout(store)} vs "
                             f"{_layout(self.store)}")
        self.store = store
        self._ts_next = int(ts_next)
        self._snapshots.clear()
        self._declare_metrics()
        self._reset_policy()
        return [self.begin_snapshot(int(ts)) for ts in pins]

    # -- snapshot-read path (zero CC bookkeeping) --------------------------
    def current_ts(self) -> int:
        """Snapshot timestamp that sees exactly the committed transactions:
        the last assigned global ts."""
        return self._ts_next - 1

    def watermark(self) -> int:
        """Low watermark: min active reader snapshot ts, else the next
        unassigned ts."""
        return min([s.ts for s in self._snapshots.values()]
                   + [self._ts_next])

    def claim_ts_window(self, n_txns: int) -> Tuple[int, int]:
        """Reserve the next ``n_txns`` global timestamps and return the
        half-open window ``(lo, lo + n_txns)``."""
        lo = self._ts_next
        self._ts_next += n_txns
        return lo, lo + n_txns

    def pin_array(self) -> torch.Tensor:
        """Registered snapshot pin timestamps as a device vector, sorted
        and INF_TS-padded to a power-of-two length."""
        pins = sorted(s.ts for s in self._snapshots.values())
        n = 1
        while n < len(pins):
            n *= 2
        pins = pins + [INF_TS] * (n - len(pins))
        return i32(pins, self.device)

    def gc_sweep(self) -> int:
        """Standalone precise GC at the current watermark (primary +
        spill). With ``adaptive_k`` the sweep is also the policy boundary:
        when commits landed since the last sweep, the accumulated
        live-eviction histogram drives one ``reassign_k`` pass. The pass
        is a fixpoint, so consecutive sweeps with no commits in between
        leave the store byte-identical. Returns the number of versions
        reclaimed; synchronises on it."""
        wm_host = self.watermark()
        with self.tracer.span("gc_sweep", watermark=wm_host) as sp:
            wm = i32(wm_host, self.device)
            if self.auditor.enabled:
                versions, evicted, gc_audit = gc_sharded_audited(
                    self.store.versions, wm, self.pin_array(),
                    event_cap=self.auditor.gc_event_cap)
                self.auditor.on_gc(gc_audit, wm_host)
            else:
                versions, evicted = gc_sharded(self.store.versions, wm)
            if self.adaptive_k and self._commits_since_sweep > 0:
                versions = self._run_policy(versions)
            self.store = dataclasses.replace(self.store, versions=versions)
            evicted = int(evicted)
            sp.note(reclaimed=evicted)
        self.metrics.inc("engine/gc_sweeps")
        self.metrics.inc("engine/gc_reclaimed", evicted)
        # the sweep is a harvest boundary (one transfer; the hot path
        # between sweeps never joins the host for the audit)
        if self.auditor.enabled:
            self.auditor.harvest()
        return evicted

    def _run_policy(self, versions):
        """One adaptive-K ``reassign_k`` pass at the sweep boundary, on the
        host (its own trace span). The policy's three [R] inputs — the
        live-eviction histogram, ``k_eff`` and the occupancy after the
        sweep — cross to the host in one transfer."""
        with self.tracer.span("reassign_k") as sp:
            host = torch.stack([
                to_global(versions,
                          self.metrics.peek("engine/ring_overwrote_rec")),
                to_global(versions, versions.k_eff),
                store_occupancy(versions)]).cpu().numpy()
            cumulative = host[0].astype(np.int64)
            k_glob, occ = host[1], host[2]
            if self.pressure_decay is None:
                pressure = cumulative
            else:
                # EWMA over per-sweep deltas: a cooled record's pressure
                # halves every ``pressure_decay`` sweeps and truncates to
                # zero — it becomes a donor and its capacity flows on
                self._pressure_ewma = decay_pressure(
                    self._pressure_ewma,
                    cumulative - self._overflow_at_sweep,
                    self.pressure_decay)
                self._overflow_at_sweep = cumulative
                pressure = self._pressure_ewma
            idle = occ <= 1
            new_k = reassign_k(pressure, k_glob, k_min=self.k_min,
                               k_max=self.k_max, k_base=self.ring_slots,
                               occupancy=occ,
                               stable_idle=idle & self._stable_idle,
                               budget=self.num_records * self.ring_slots,
                               quantum=self.k_quantum)
            self._stable_idle = idle
            self._commits_since_sweep = 0
            moved = reassign_stats(k_glob, new_k, self.k_quantum)
            sp.note(**moved)
            self.metrics.inc("engine/k_slots_granted",
                             moved["slots_granted"])
            self.metrics.inc("engine/k_slots_reclaimed",
                             moved["slots_reclaimed"])
            k_sh = from_global(versions, i32(new_k, self.device),
                               pad_value=self.k_min)
            # insertion cursors must stay inside the (possibly shrunk)
            # effective window; grown records keep their cursor as-is
            if versions.rings is not None:
                prim = dataclasses.replace(
                    versions.rings, head=versions.rings.head % k_sh)
                versions = dataclasses.replace(versions, rings=prim,
                                               k_eff=k_sh)
            else:
                prim = dataclasses.replace(
                    versions.pages, head=versions.pages.head % k_sh)
                versions = dataclasses.replace(versions, pages=prim,
                                               k_eff=k_sh)
        return versions

    def k_by_record(self) -> torch.Tensor:
        """[R] effective primary capacity per record (adaptive K)."""
        return to_global(self.store.versions, self.store.versions.k_eff)

    def begin_snapshot(self, ts: Optional[int] = None) -> SnapshotHandle:
        """Register a reader at ``ts`` (default: now)."""
        handle = SnapshotHandle(self._next_sid,
                                self.current_ts() if ts is None
                                else int(ts),
                                t_wall=time.monotonic())
        self._next_sid += 1
        self._snapshots[handle.sid] = handle
        return handle

    def release_snapshot(self, handle: SnapshotHandle) -> None:
        self._snapshots.pop(handle.sid, None)

    def snapshot_windows(self, records) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
        """Gathered (begin, end, payload) candidate windows per record —
        the input layout of the ``mvcc_resolve`` kernel's windows form
        (reads take the store in place)."""
        return gather_windows_sharded(self.store.versions,
                                      i32(records, self.device))

    def snapshot_read(self, records, ts=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Resolve ``records`` [B] at snapshot ``ts`` through the kernels,
        primary level then spill pool. Returns (vals [B, D], found [B]);
        found=False means the visible version was never written or was
        lost, never a stale payload."""
        if isinstance(ts, SnapshotHandle):
            ts = ts.ts
        if ts is None:
            ts = self.current_ts()
        records = i32(records, self.device)
        ts_vec = torch.full((records.shape[0],), int(ts), dtype=torch.int32,
                            device=self.device)
        return resolve_sharded(self.store.versions, records, ts_vec)

    def run_readonly_batch(self, batch: TxnBatch, ts=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      Dict[str, torch.Tensor]]:
        """Execute read-only transactions against the snapshot at ``ts``:
        no CC phase, no placeholder versions, no writes to shared state.
        Returns (read_vals [T, Rd, D], found [T, Rd], metrics)."""
        if isinstance(ts, SnapshotHandle):
            ts = ts.ts
        if ts is None:
            ts = self.current_ts()
        with self.tracer.span("read/resolve", txns=batch.size,
                              ts=int(ts)) as sp:
            vals, found, metrics = _readonly_resolve(
                self.store.versions, batch.read_set.to(self.device),
                i32(int(ts), self.device))
            sp.fence(vals)
        return vals, found, metrics

    # -- K-ring pressure diagnostics ---------------------------------------
    def record_commit_metrics(self, metrics: Dict[str, torch.Tensor],
                              n_txns: int = 0) -> None:
        """Fold a commit's metric outputs into the registry: every
        accumulation is a lazy on-device add."""
        m = self.metrics
        for key in ("ring_overwrote_rec", "ring_overwrote_dead_rec",
                    "ring_overwrote_live", "ring_overwrote_dead",
                    "paged_alloc_failed", "aborts", "waves",
                    *self._SPILL_KEYS):
            if key in metrics:
                m.accumulate(f"engine/{key}", metrics[key])
        m.inc("engine/commits")
        m.inc("engine/txns_committed", n_txns)
        self._commits_since_sweep += 1
        # stash the audit_* tensors (popped, so result fan-out never
        # carries them) and fold the lifecycle counters, on the device
        self.auditor.on_commit(metrics)

    def overflow_by_record(self) -> torch.Tensor:
        """[R] cumulative count of LIVE version evictions per record."""
        return to_global(self.store.versions,
                         self.metrics.peek("engine/ring_overwrote_rec"))

    def overflow_stats(self, top_k: int = 8) -> Dict[str, object]:
        """Host-side K-ring pressure summary: live evictions, the top-k
        hottest records and power-of-two histograms of live and dead
        per-record eviction counts. Diagnostic API — synchronises."""
        counts = self.overflow_by_record().cpu()
        dead = to_global(self.store.versions, self.metrics.peek(
            "engine/ring_overwrote_dead_rec")).cpu()
        k = min(top_k, self.num_records)
        # stable descending sort: ties keep the lower record first, as
        # XLA's top_k does
        top_vals, top_recs = torch.sort(counts, descending=True,
                                        stable=True)
        edges = [0, 1, 2, 4, 8, 16, 32, 64]
        return {
            "total_overwrites": int(counts.sum()),
            "records_affected": int((counts > 0).sum()),
            "top_records": [(int(r), int(v)) for r, v in
                            zip(top_recs[:k], top_vals[:k]) if v > 0],
            "histogram": _bucket_histogram(counts, edges),
            "dead_overwrites": int(dead.sum()),
            "dead_histogram": _bucket_histogram(dead, edges),
        }

    def spill_stats(self) -> Dict[str, int]:
        """Spill-tier summary: pool occupancy/capacity plus the cumulative
        admitted / dropped / pinned-overwrite counters."""
        spill = self.store.versions.spill
        occupancy = 0 if spill is None else int((spill.rec >= 0).sum())
        capacity = 0 if spill is None else (
            self.n_shards * self.spill_buckets * self.spill_slots)
        return dict({k: int(self.metrics.value(f"engine/{k}"))
                     for k in self._SPILL_KEYS},
                    spill_occupancy=occupancy, spill_capacity=capacity)

    def storage_stats(self) -> Dict[str, object]:
        """Physical storage summary: how many version slots the primary
        level allocates and how full they are, against the
        dense-equivalent footprint R x ``k_max``. ``physical_slots``
        counts allocated slot capacity (dense: R x k_max; paged: the whole
        slab, free pages included — ``mapped_slots`` is the in-use
        subset); ``physical_version_words`` prices it at (begin, end,
        payload) words per slot plus the page tables. Synchronises."""
        D = self.workload.payload_words
        versions = self.store.versions
        dense_slots = self.num_records * self.k_max
        stats: Dict[str, object] = {
            "layout": "paged" if self.paged else "dense",
            "num_records": self.num_records,
            "k_max": self.k_max,
            "dense_equiv_slots": dense_slots,
            "dense_equiv_words": dense_slots * (2 + D),
            "slot_occupancy": int(store_occupancy(versions).sum()),
        }
        if self.paged:
            pages = versions.pages
            mapped = int((pages.page_table >= 0).sum())
            total = self.n_shards * self.pages_per_shard
            stats.update({
                "page_slots": self.page_slots,
                "pages_total": total,
                "pages_mapped": mapped,
                "pages_free": total - mapped,
                "physical_slots": total * self.page_slots,
                "mapped_slots": mapped * self.page_slots,
                # slab + page tables; tables cost one i32 per entry
                "physical_version_words": (
                    total * self.page_slots * (2 + D)
                    + self.n_shards * versions.records_per_shard
                    * pages.max_pages),
                "alloc_failed": int(
                    self.metrics.value("engine/paged_alloc_failed")),
            })
        else:
            stats.update({
                "physical_slots": dense_slots,
                "physical_version_words": dense_slots * (2 + D),
            })
        return stats

    def health(self) -> Dict[str, object]:
        """MVCC health gauges (watermark lag, pin ages, ring/slab/spill
        saturation, pressure percentiles), derived from store state in one
        transfer — see ``repro_torch.obs.health``. Synchronises."""
        return engine_health(self)

    def inspect_record(self, record: int):
        """Time-travel inspector for one record (requires an enabled
        ``auditor``): resident versions across ring/slab/spill merged
        with the harvested transition events — see
        ``repro_torch.obs.LifecycleAuditor.inspect_record``."""
        if not self.auditor.enabled:
            raise RuntimeError(
                "inspect_record requires BohmEngine(auditor=...)")
        return self.auditor.inspect_record(record)


def _layout(store: Store) -> Tuple:
    """Shapes that fix an engine's configuration: heads, the primary
    level (dense rings or page slab + table), capacities, spill."""
    v = store.versions
    prim = (("rings", tuple(v.rings.payload.shape)) if v.rings is not None
            else ("pages", tuple(v.pages.payload.shape),
                  tuple(v.pages.page_table.shape)))
    return (tuple(store.base.shape), prim, tuple(v.k_eff.shape),
            None if v.spill is None else tuple(v.spill.begin.shape))


def _bucket_histogram(counts: torch.Tensor, edges: List[int]
                      ) -> List[Tuple[str, int]]:
    """[(bucket label, n_records)] for counts bucketed by [lo, hi)."""
    out = []
    for i, lo in enumerate(edges):
        hi = edges[i + 1] if i + 1 < len(edges) else None
        if hi is None:
            n = int((counts >= lo).sum())
            label = f"{lo}+"
        else:
            n = int(((counts >= lo) & (counts < hi)).sum())
            label = f"{lo}" if hi == lo + 1 else f"{lo}-{hi - 1}"
        out.append((label, n))
    return out


# ---------------------------------------------------------------------------
# The phase graph: plan (CC) -> exec (wavefront) -> commit (barrier).
# ---------------------------------------------------------------------------
def plan_phase(batch: TxnBatch, ts_base) -> Plan:
    """CC phase: timestamps + placeholder versions + read annotations."""
    return cc_plan(batch, ts_base)


def exec_phase(plan: Plan, batch: TxnBatch, store: Store, *,
               workload: Workload):
    """Execution wavefront only. Returns (w_data, read_vals, metrics)."""
    return execute_plan(plan, batch, store, workload)


def commit_phase(plan: Plan, batch: TxnBatch, store: Store,
                 w_data: torch.Tensor, watermark=None, ts_window=None,
                 pin_ts: Optional[torch.Tensor] = None, *,
                 with_audit: bool = False):
    """Watermark-driven commit of an executed batch."""
    return commit(plan, batch, store, w_data, watermark,
                  ts_window=ts_window, pin_ts=pin_ts, with_audit=with_audit)


def exec_commit_phase(plan: Plan, batch: TxnBatch, store: Store,
                      watermark=None, pin_ts: Optional[torch.Tensor] = None,
                      *, workload: Workload):
    """Exec + commit composed (the reference's fused twin, which
    ``bohm_step`` builds on). Returns (new_store, read_vals, metrics)."""
    w_data, read_vals, metrics = exec_phase(plan, batch, store,
                                            workload=workload)
    new_store, ring_metrics = commit_phase(plan, batch, store, w_data,
                                           watermark, pin_ts=pin_ts)
    return new_store, read_vals, dict(metrics, **ring_metrics)


def bohm_step(store: Store, batch: TxnBatch, watermark=None,
              pin_ts: Optional[torch.Tensor] = None, *, workload: Workload):
    """One batch through plan, exec and commit on ``store``, without
    touching an engine's state (what ``benchmarks_torch/microbench.py``
    times, as the reference times ``BohmEngine._step``)."""
    plan = plan_phase(batch, store.ts_counter)
    return exec_commit_phase(plan, batch, store, watermark, pin_ts,
                             workload=workload)


def _readonly_resolve(versions, read_set: torch.Tensor, ts: torch.Tensor):
    """A read-only batch: resolve visibility through the kernels (primary
    level, then spill), mask pads."""
    T, Rd = read_set.shape
    flat = read_set.reshape(-1).clamp(min=0)
    ts_vec = ts.to(torch.int32).expand(flat.shape[0]).contiguous()
    vals, found = resolve_sharded(versions, flat, ts_vec)
    valid = read_set >= 0
    vals = torch.where(valid[..., None], vals.reshape(T, Rd, -1), 0)
    found = torch.where(valid, found.reshape(T, Rd), True)
    occ = store_occupancy(versions)
    n_valid = valid.sum().clamp(min=1)
    metrics = {"found_frac": (found & valid).sum() / n_valid,
               "ring_occ_max": occ.max()}
    return vals, found, metrics


# ---------------------------------------------------------------------------
# Serial oracle (serializability ground truth): execute transactions one by
# one in timestamp order against a single-version store.
# ---------------------------------------------------------------------------
def serial_oracle(store_base: torch.Tensor, batch: TxnBatch,
                  workload: Workload
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final_base [R, D], read_vals [T, Rd, D])."""
    R, D = store_base.shape
    T, W = batch.write_set.shape
    # a private copy with one sentinel row that absorbs pad writes
    ext = torch.cat([store_base, store_base.new_zeros((1, D))])
    reads = torch.zeros((T,) + tuple(batch.read_set.shape[1:]) + (D,),
                        dtype=store_base.dtype, device=store_base.device)
    for t in range(T):
        read_set = batch.read_set[t]
        vals = ext[read_set.clamp(min=0).long()]                 # [Rd, D]
        vals = torch.where((read_set >= 0)[:, None], vals, 0)
        write_vals, _ = workload.apply(batch.txn_type[t:t + 1], vals[None],
                                       batch.args[t:t + 1])
        rec = torch.where(batch.write_set[t] >= 0, batch.write_set[t],
                          R).long()
        # one write column at a time: a record named twice takes the
        # later column's value (program order)
        for w in range(W):
            ext[rec[w:w + 1]] = write_vals[0, w:w + 1]
        reads[t] = vals
    return ext[:-1], reads


def serial_oracle_prefix(store_base: torch.Tensor, batch: TxnBatch,
                         workload: Workload, n_txns: int) -> torch.Tensor:
    """Oracle state after only the first ``n_txns`` of ``batch``."""
    final, _ = serial_oracle(store_base, batch.slice(n_txns), workload)
    return final
