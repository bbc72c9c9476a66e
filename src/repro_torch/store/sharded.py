"""Record-partitioned version store, ``n_shards == 1`` subset.

The port of ``repro.store.sharded``. The store keeps the reference's
stacked layout — a primary level of dense rings [n, Rl, K] OR a paged
slab [n, P, S] + page table [n, Rl, MaxP] (``repro_torch.store.pages``),
spill pools [n, B, S], ``k_eff`` [n, Rl] — with a leading shard axis of
size 1, so state carries across from a reference engine unchanged
(``repro_torch.core.carry``). With one shard every path short-circuits
to the single-primary code, exactly as the reference's ``n_shards == 1``
fast path does.

Snapshot reads are two-level: the primary goes through ``mvcc_resolve``
(dense: pre-gathered ring windows) or ``mvcc_resolve_paged`` (paged: the
reads' page-table rows, the slab read in place), then the record's spill
bucket goes through ``mvcc_resolve_masked``; at most one level holds the
visible version, so combining is a select.

Not ported yet (each raises ``NotImplementedError``): ``n_shards > 1``
logical shards and the ``mesh=`` substrate (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.store.pages import (PageSlab, commit_paged,
                                     gather_windows_paged, gc_pages,
                                     init_page_slab, paged_occupancy,
                                     slab_fill_fraction)
from repro_torch.store.ring import (INF_TS, VersionRing, commit_versions,
                                    gather_windows, gc_ring, i32,
                                    ring_occupancy)
from repro_torch.store.spill import (SpillPool, gc_spill, init_spill_pool,
                                     spill_buckets_for, spill_commit,
                                     spill_fill_fraction, spill_occupancy)

_EVICT_KEYS = ("evict_rec", "evict_begin", "evict_end", "evict_payload",
               "evict_valid")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: repro_torch runs one shard "
        "(ROADMAP.md, queue 1)")


@dataclasses.dataclass(frozen=True)
class ShardedVersionStore:
    """Primary version storage + spill pool stacked over a leading shard
    axis. The primary level is EITHER ``rings`` (dense [n, Rl, K]) OR
    ``pages`` (a paged slab [n, P, S] + page table [n, Rl, MaxP]);
    exactly one is set. ``k_eff`` [n, Rl] is each record's effective
    primary capacity (adaptive K; insertion-only — resolution and GC
    always scan all physical slots)."""
    rings: Optional[VersionRing]  # stacked: begin/end [n, Rl, K] or None
    spill: Optional[SpillPool]    # stacked [n, B, S, ...] or None
    k_eff: torch.Tensor           # [n, Rl] i32 per-record ring capacity
    num_records: int              # global record count (static)
    pages: Optional[PageSlab] = None   # stacked [n, P, S, ...] or None

    @property
    def paged(self) -> bool:
        return self.pages is not None

    @property
    def n_shards(self) -> int:
        return _primary_key(self).shape[0]

    @property
    def records_per_shard(self) -> int:
        return _primary_key(self).shape[1]

    @property
    def num_slots(self) -> int:
        """Logical slot ceiling per record (dense K, or MaxP * S)."""
        if self.rings is not None:
            return self.rings.begin.shape[2]
        return self.pages.page_table.shape[2] * self.pages.begin.shape[2]


def _primary_key(store: ShardedVersionStore) -> torch.Tensor:
    """The [n, Rl, ...] array that fixes the shard layout."""
    return (store.rings.begin if store.rings is not None
            else store.pages.page_table)


def _map(fn, obj):
    """Apply ``fn`` to every tensor field of a frozen dataclass."""
    return type(obj)(*(fn(getattr(obj, f.name))
                       for f in dataclasses.fields(obj)))


def _primary(store: ShardedVersionStore):
    """The stacked primary level: rings or pages (exactly one is set)."""
    return store.rings if store.rings is not None else store.pages


def _with_primary(store: ShardedVersionStore, prim) -> ShardedVersionStore:
    if store.rings is not None:
        return dataclasses.replace(store, rings=prim)
    return dataclasses.replace(store, pages=prim)


def _ring0(store: ShardedVersionStore):
    """The squeezed single primary (ring or slab) of an n_shards == 1
    store."""
    return _map(lambda x: x[0], _primary(store))


def _take_spill(store: ShardedVersionStore, s: int) -> Optional[SpillPool]:
    if store.spill is None:
        return None
    return _map(lambda x: x[s], store.spill)


def init_sharded_store(base: torch.Tensor,
                       base_ts: Optional[torch.Tensor] = None,
                       num_slots: int = 4, n_shards: int = 1,
                       spill_buckets: int = 0, spill_slots: int = 0,
                       k_init: Optional[int] = None, paged: bool = False,
                       page_slots: int = 4,
                       pages_per_shard: Optional[int] = None
                       ) -> ShardedVersionStore:
    """Store whose slot 0 holds the initial open version of every record;
    ``spill_buckets`` x ``spill_slots`` > 0 attaches a spill pool;
    ``k_init`` caps each record's effective capacity below the physical
    ``num_slots`` (the adaptive-K starting point).

    ``paged=True`` replaces the dense [R, K] ring with a page slab of
    ``pages_per_shard`` pages of ``page_slots`` slots and page tables of
    ``ceil(num_slots / page_slots)`` entries; every record starts with
    exactly its initial page."""
    if int(n_shards) != 1:
        raise _unported("n_shards > 1")
    R, D = base.shape
    dev = base.device
    if base_ts is None:
        base_ts = torch.zeros((R,), dtype=torch.int32, device=dev)
    base_ts = base_ts.to(torch.int32)
    rings = pages = None
    if paged:
        max_pages = -(-int(num_slots) // int(page_slots))
        if pages_per_shard is None:
            # per-record ceiling, NOT the pooled slot budget: every record
            # needs ceil(k / S) whole pages to physically reach its k_eff
            pages_per_shard = R * -(-int(k_init or num_slots)
                                    // int(page_slots))
        real = torch.ones((R,), dtype=torch.bool, device=dev)
        pages = _map(lambda x: x[None],
                     init_page_slab(base, base_ts, real, pages_per_shard,
                                    page_slots, max_pages))
    else:
        begin = torch.full((1, R, num_slots), INF_TS, dtype=torch.int32,
                           device=dev)
        begin[0, :, 0] = base_ts
        end = torch.full((1, R, num_slots), INF_TS, dtype=torch.int32,
                         device=dev)
        payload = torch.zeros((1, R, num_slots, D), dtype=base.dtype,
                              device=dev)
        payload[0, :, 0, :] = base
        head = torch.full((1, R), 1 % num_slots, dtype=torch.int32,
                          device=dev)
        rings = VersionRing(begin=begin, end=end, payload=payload,
                            head=head)
    spill = None
    if int(spill_buckets) > 0 and int(spill_slots) > 0:
        spill = _map(lambda x: x[None],
                     init_spill_pool(spill_buckets, spill_slots, D,
                                     base.dtype, dev))
    k0 = num_slots if k_init is None else min(int(k_init), num_slots)
    return ShardedVersionStore(
        rings=rings, spill=spill,
        k_eff=torch.full((1, R), k0, dtype=torch.int32, device=dev),
        num_records=R, pages=pages)


def unshard(store: ShardedVersionStore) -> VersionRing:
    """Materialise the global [R, K] ring. Tests/debug only."""
    if store.rings is None:
        raise ValueError("unshard materialises dense rings; a paged "
                         "store has no global [R, K] layout — compare "
                         "reads (resolve_sharded) or use "
                         "gather_windows_sharded instead")
    return _map(lambda x: to_global(store, x), store.rings)


def to_global(store: ShardedVersionStore,
              per_shard: torch.Tensor) -> torch.Tensor:
    """Re-index a per-shard [n, Rl] record statistic to global [R]."""
    n, Rl = store.n_shards, store.records_per_shard
    return per_shard.movedim(0, 1).reshape(
        (Rl * n,) + tuple(per_shard.shape[2:]))[:store.num_records]


def from_global(store: ShardedVersionStore, per_record: torch.Tensor,
                pad_value: int = 0) -> torch.Tensor:
    """Inverse of ``to_global`` (hash-padding records get ``pad_value``)."""
    n, Rl = store.n_shards, store.records_per_shard
    pad = Rl * n - store.num_records
    fill = torch.full((pad,) + tuple(per_record.shape[1:]), pad_value,
                      dtype=per_record.dtype, device=per_record.device)
    padded = torch.cat([per_record, fill])
    return padded.reshape((Rl, n) + tuple(per_record.shape[1:])).movedim(
        0, 1)


def _occupancy(store: ShardedVersionStore) -> torch.Tensor:
    """[n, Rl] live version count per record."""
    if store.rings is not None:
        return ring_occupancy(store.rings)
    return paged_occupancy(_ring0(store))[None]


def store_occupancy(store: ShardedVersionStore) -> torch.Tensor:
    """[R] live version count per global record."""
    return to_global(store, _occupancy(store))


def store_health(store: ShardedVersionStore) -> Dict[str, torch.Tensor]:
    """Per-shard health gauges as device tensors (nothing here
    synchronises):

      live_versions [n]   live version count per shard
      k_eff_slots   [n]   effective (policy-granted) slot capacity
      pages_mapped / pages_free / slab_fill [n]  (paged stores)
      spill_occupancy / spill_fill [n]           (spill tier attached)
    """
    out: Dict[str, torch.Tensor] = {
        "k_eff_slots": store.k_eff.sum(-1, dtype=torch.int32),
        "live_versions": _occupancy(store).sum(-1, dtype=torch.int32)}
    if store.pages is not None:
        mapped = (store.pages.page_table >= 0).sum((1, 2),
                                                   dtype=torch.int32)
        out["pages_mapped"] = mapped
        out["pages_free"] = store.pages.num_pages - mapped
        out["slab_fill"] = slab_fill_fraction(_ring0(store))[None]
    if store.spill is not None:
        pool = _take_spill(store, 0)
        out["spill_occupancy"] = spill_occupancy(pool)[None]
        out["spill_fill"] = spill_fill_fraction(pool)[None]
    return out


# ---------------------------------------------------------------------------
# Commit: ring maintenance (GC + insert) then the spill tier.
# ---------------------------------------------------------------------------
def _commit_one_shard(ring_s, spill_s: Optional[SpillPool],
                      k_eff_s: torch.Tensor, rec_l, key_l, owned,
                      w_begin_ts, w_end_ts, w_data, watermark, ts_window,
                      pin_ts):
    """One shard's commit: primary maintenance (dense ring or paged slab
    — same contract, dispatched on the type), then its live evictees
    into the spill pool at the same clamped watermark."""
    with_spill = spill_s is not None
    commit_fn = commit_paged if isinstance(ring_s, PageSlab) \
        else commit_versions
    ring_o, m = commit_fn(ring_s, rec_l, key_l, owned, w_begin_ts,
                          w_end_ts, w_data, watermark, ts_window=ts_window,
                          k_eff=k_eff_s, pin_ts=pin_ts,
                          with_evictees=with_spill)
    if with_spill:
        ev = {k: m.pop(k) for k in _EVICT_KEYS}
        wm = i32(watermark, w_data.device)
        if ts_window is not None:
            wm = torch.minimum(wm, i32(ts_window[0], w_data.device))
        spill_s, sm = spill_commit(spill_s, ev["evict_rec"],
                                   ev["evict_begin"], ev["evict_end"],
                                   ev["evict_payload"], ev["evict_valid"],
                                   wm, pin_ts=pin_ts)
        m.update(sm)
    return ring_o, spill_s, m


def commit_sharded(store: ShardedVersionStore, w_rec: torch.Tensor,
                   w_key: torch.Tensor, w_valid: torch.Tensor,
                   w_begin_ts: torch.Tensor, w_end_ts: torch.Tensor,
                   w_data: torch.Tensor, watermark, mesh=None,
                   ts_window: Optional[Tuple] = None,
                   pin_ts: Optional[torch.Tensor] = None
                   ) -> Tuple[ShardedVersionStore, Dict[str, torch.Tensor]]:
    """Commit ALL batch versions into the primary (and live evictees
    into the spill pool). ``ring_overwrote_rec`` /
    ``ring_overwrote_dead_rec`` keep the per-shard [n, Rl] layout, as in
    the reference; a paged store adds the allocator's counters."""
    if mesh is not None:
        raise _unported("the mesh= substrate")
    ring, spill0, metrics = _commit_one_shard(
        _ring0(store), _take_spill(store, 0), store.k_eff[0], w_rec, w_key,
        w_valid, w_begin_ts, w_end_ts, w_data, watermark, ts_window, pin_ts)
    for k in ("ring_overwrote_rec", "ring_overwrote_dead_rec"):
        metrics[k] = metrics[k][None]
    new_spill = None if spill0 is None else _map(lambda x: x[None], spill0)
    return dataclasses.replace(
        _with_primary(store, _map(lambda x: x[None], ring)),
        spill=new_spill), metrics


def gc_sharded(store: ShardedVersionStore, watermark
               ) -> Tuple[ShardedVersionStore, torch.Tensor]:
    """Standalone watermark GC sweep over the primary and the spill pool
    (see ``gc_ring`` / ``gc_pages`` / ``gc_spill``). The paged sweep also
    returns fully drained stranded pages to the free list."""
    if store.rings is not None:
        prim, evicted = gc_ring(store.rings, watermark)
    else:
        slab, evicted = gc_pages(_ring0(store), watermark, store.k_eff[0])
        prim = _map(lambda x: x[None], slab)
    spill = store.spill
    if spill is not None:
        spill, freed = gc_spill(spill, watermark)
        evicted = evicted + freed
    return dataclasses.replace(_with_primary(store, prim),
                               spill=spill), evicted


# ---------------------------------------------------------------------------
# Snapshot reads: gather + mvcc_resolve (primary), then the spill
# fall-through through mvcc_resolve_masked.
# ---------------------------------------------------------------------------
def gather_windows_sharded(store: ShardedVersionStore,
                           records: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(begin [B, K], end [B, K], payload [B, K, D]) primary windows. For
    a paged store they are materialised through the page table (K =
    MaxP * S, unmapped pages give empty slots) — a diagnostic path; reads
    go through ``mvcc_resolve_paged``."""
    prim = _ring0(store)
    if isinstance(prim, PageSlab):
        return gather_windows_paged(prim, records)
    return gather_windows(prim, records)


def _resolve_two_level(prim_s, spill_s: Optional[SpillPool],
                       local_rec: torch.Tensor, ts: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary resolve with the spill fall-through: a version leaves the
    primary exactly when it moves to spill and [begin, end) windows
    partition a record's timeline, so at most one level holds the
    version visible at ``ts`` and combining is a select. A dense primary
    resolves pre-gathered windows through ``mvcc_resolve``; a page slab
    resolves the reads' page-table rows through ``mvcc_resolve_paged``."""
    if isinstance(prim_s, PageSlab):
        rows = prim_s.page_table[local_rec.long()]
        vals, found = ops.mvcc_resolve_paged(rows, prim_s.begin, prim_s.end,
                                             prim_s.payload, ts)
    else:
        begin, end, payload = gather_windows(prim_s, local_rec)
        vals, found = ops.mvcc_resolve(begin, end, payload, ts)
    if spill_s is None:
        return vals, found
    bkt = spill_buckets_for(local_rec, spill_s.begin.shape[0]).long()
    s_vals, s_found = ops.mvcc_resolve_masked(
        spill_s.begin[bkt], spill_s.end[bkt], spill_s.rec[bkt],
        local_rec, spill_s.payload[bkt], ts)
    return torch.where(found[:, None], vals, s_vals), found | s_found


def resolve_sharded(store: ShardedVersionStore, records: torch.Tensor,
                    ts: torch.Tensor, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve ``records`` [B] at snapshot timestamps ``ts`` [B] through
    the kernels, primary level then spill. Returns (vals [B, D], found
    [B])."""
    if mesh is not None:
        raise _unported("the mesh= substrate")
    local = records.to(torch.int32).clamp(min=0).contiguous()
    return _resolve_two_level(_ring0(store), _take_spill(store, 0), local,
                              ts.to(torch.int32).contiguous())
