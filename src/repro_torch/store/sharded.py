"""Record-partitioned version store: logical shards on one device.

The port of ``repro.store.sharded``. Global record ``r`` is owned by
shard ``r % n`` at local index ``r // n``; the store keeps the
reference's stacked layout — a primary level of dense rings [n, Rl, K]
OR a paged slab [n, P, S] + page table [n, Rl, MaxP]
(``repro_torch.store.pages``), spill pools [n, B, S], ``k_eff``
[n, Rl] — with ``Rl = ceil(R / n)`` (records past ``R`` are
hash-padding: empty rings, no pages, never read or written), so state
carries across from a reference engine unchanged
(``repro_torch.core.carry``).

The reference's no-mesh substrate ``vmap``s the per-shard commit over
the shard axis; here it is a loop over shards whose results are stacked
(the per-shard arithmetic is the same, so the state is byte-equal).
At ``n_shards == 1`` ``commit_sharded`` and ``resolve_sharded`` keep
the reference's fast path, for two reasons. The loop would stack a copy
of the whole store every batch, where the fast path adds a shard axis
to a view. And the reference clamps a negative record id to 0 only on
that path (the loop's ownership test sends it to the last shard), which
the parity tests hold the port to. On both paths an id past the store
reads its shard's last row, as the reference's clamped gathers do.

Snapshot reads are two-level per shard: the primary goes through
``mvcc_resolve`` (dense: the ring's rows read in place) or
``mvcc_resolve_paged`` (paged: the page table's rows and the slab read
in place), then ``mvcc_resolve_masked`` reads the record's spill bucket
in place with the primary's result as its prior; at most one level
holds the visible version, so combining is a select, done inside that
launch. Each read has one owning shard; the shards' results merge by
ownership (foreign shards contribute zeros).

Not ported yet (raises ``NotImplementedError``): the ``mesh=`` substrate
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.store.pages import (PageSlab, commit_paged, gc_pages,
                                     init_page_slab, mask_gathered_windows,
                                     paged_occupancy, slab_fill_fraction)
from repro_torch.store.ring import (INF_TS, VersionRing, commit_versions,
                                    gc_ring, i32, ring_occupancy)
from repro_torch.store.spill import (SpillPool, gc_spill, init_spill_pool,
                                     spill_commit, spill_fill_fraction,
                                     spill_occupancy)

PAD_KEY = 0xFFFFFFFF      # the plan's pad key (repro_torch.core.plan)

_EVICT_KEYS = ("evict_rec", "evict_begin", "evict_end", "evict_payload",
               "evict_valid")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: repro_torch runs logical shards on "
        "one device (ROADMAP.md, queue 1)")


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
    return _take_shard(store, 0)


def _take_shard(store: ShardedVersionStore, s: int):
    """Shard ``s``'s primary (ring or slab), the shard axis dropped."""
    return _map(lambda x: x[s], _primary(store))


def _stack(parts):
    """Stack per-shard dataclasses (rings, slabs, pools) along a new
    leading shard axis."""
    first = parts[0]
    return type(first)(*(torch.stack([getattr(p, f.name) for p in parts])
                         for f in dataclasses.fields(first)))


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
    exactly its initial page. Global record ``r`` lands at
    ``[r % n_shards, r // n_shards]``."""
    R, D = base.shape
    dev = base.device
    if base_ts is None:
        base_ts = torch.zeros((R,), dtype=torch.int32, device=dev)
    n = int(n_shards)
    if n < 1:
        raise ValueError("n_shards must be >= 1")
    Rl = -(-R // n)
    pad = Rl * n - R
    basep = torch.cat([base, base.new_zeros((pad, D))])
    tsp = torch.cat([base_ts.to(torch.int32),
                     torch.zeros((pad,), dtype=torch.int32, device=dev)])
    base_sh = basep.reshape(Rl, n, D).movedim(0, 1)          # [n, Rl, D]
    ts_sh = tsp.reshape(Rl, n).T                             # [n, Rl]
    real = global_record_ids(n, Rl, dev) < R                 # [n, Rl]
    rings = pages = None
    if paged:
        max_pages = -(-int(num_slots) // int(page_slots))
        if pages_per_shard is None:
            # per-record ceiling, NOT the pooled slot budget: every record
            # needs ceil(k / S) whole pages to physically reach its k_eff
            pages_per_shard = Rl * -(-int(k_init or num_slots)
                                     // int(page_slots))
        pages = _stack([init_page_slab(base_sh[s], ts_sh[s], real[s],
                                       pages_per_shard, page_slots,
                                       max_pages) for s in range(n)])
    else:
        begin = torch.full((n, Rl, num_slots), INF_TS, dtype=torch.int32,
                           device=dev)
        begin[:, :, 0] = torch.where(real, ts_sh, INF_TS)
        end = torch.full((n, Rl, num_slots), INF_TS, dtype=torch.int32,
                         device=dev)
        payload = torch.zeros((n, Rl, num_slots, D), dtype=base.dtype,
                              device=dev)
        payload[:, :, 0, :] = torch.where(real[..., None], base_sh, 0)
        head = torch.full((n, Rl), 1 % num_slots, dtype=torch.int32,
                          device=dev)
        rings = VersionRing(begin=begin, end=end, payload=payload,
                            head=head)
    spill = None
    if int(spill_buckets) > 0 and int(spill_slots) > 0:
        pool = init_spill_pool(spill_buckets, spill_slots, D, base.dtype,
                               dev)
        spill = _map(lambda x: x[None].repeat((n,) + (1,) * x.dim()), pool)
    k0 = num_slots if k_init is None else min(int(k_init), num_slots)
    return ShardedVersionStore(
        rings=rings, spill=spill,
        k_eff=torch.full((n, Rl), k0, dtype=torch.int32, device=dev),
        num_records=R, pages=pages)


def global_record_ids(n_shards: int, records_per_shard: int,
                      device=None) -> torch.Tensor:
    """[n, Rl] global record id at each sharded position."""
    local = torch.arange(records_per_shard, dtype=torch.int32,
                         device=device)[None, :]
    shard = torch.arange(n_shards, dtype=torch.int32, device=device)[:, None]
    return local * n_shards + shard


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
    return torch.stack([paged_occupancy(_take_shard(store, s))
                        for s in range(store.n_shards)])


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
    shards = range(store.n_shards)
    if store.pages is not None:
        mapped = (store.pages.page_table >= 0).sum((1, 2),
                                                   dtype=torch.int32)
        out["pages_mapped"] = mapped
        out["pages_free"] = store.pages.num_pages - mapped
        out["slab_fill"] = torch.stack([
            slab_fill_fraction(_take_shard(store, s)) for s in shards])
    if store.spill is not None:
        pools = [_take_spill(store, s) for s in shards]
        out["spill_occupancy"] = torch.stack([spill_occupancy(p)
                                              for p in pools])
        out["spill_fill"] = torch.stack([spill_fill_fraction(p)
                                         for p in pools])
    return out


# ---------------------------------------------------------------------------
# Commit: per-shard ring maintenance (GC + insert) then the spill tier.
# ---------------------------------------------------------------------------
def _mask_to_shard(n: int, shard: int, w_rec, w_key, w_valid):
    """Project global placeholder arrays onto one shard: foreign records
    become pads (key 0xFFFFFFFF sorts last, valid=False drops the write),
    owned records map to their shard-local index. rec -> rec // n is
    monotone over the records a shard owns, so the key order holds."""
    owned = w_valid & ((w_rec % n) == shard)
    rec_l = torch.where(owned, torch.div(w_rec, n, rounding_mode="floor"),
                        INF_TS).to(w_rec.dtype)
    key_l = torch.where(owned, w_key, PAD_KEY)
    return rec_l, key_l, owned


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
    into the spill pool). Each shard commits only the records it owns;
    the metrics aggregate to the single-primary contract, except
    ``ring_overwrote_rec`` / ``ring_overwrote_dead_rec``, which keep the
    per-shard [n, Rl] layout as in the reference; a paged store adds the
    allocator's counters."""
    if mesh is not None:
        raise _unported("the mesh= substrate")
    n = store.n_shards
    if n == 1:
        ring, spill0, metrics = _commit_one_shard(
            _ring0(store), _take_spill(store, 0), store.k_eff[0], w_rec,
            w_key, w_valid, w_begin_ts, w_end_ts, w_data, watermark,
            ts_window, pin_ts)
        for k in ("ring_overwrote_rec", "ring_overwrote_dead_rec"):
            metrics[k] = metrics[k][None]
        new_spill = None if spill0 is None else _map(lambda x: x[None],
                                                     spill0)
        return dataclasses.replace(
            _with_primary(store, _map(lambda x: x[None], ring)),
            spill=new_spill), metrics

    prims, spills, per = [], [], []
    for s in range(n):
        rec_l, key_l, owned = _mask_to_shard(n, s, w_rec, w_key, w_valid)
        prim_s, spill_s, m = _commit_one_shard(
            _take_shard(store, s), _take_spill(store, s), store.k_eff[s],
            rec_l, key_l, owned, w_begin_ts, w_end_ts, w_data, watermark,
            ts_window, pin_ts)
        prims.append(prim_s)
        spills.append(spill_s)
        per.append(m)

    def total(key):
        return torch.stack([m[key] for m in per]).sum(dtype=torch.int32)

    metrics = {k: total(k) for k in ("ring_evicted",
                                     "ring_overflow_dropped",
                                     "ring_overwrote_live",
                                     "ring_overwrote_dead")}
    for k in ("ring_overwrote_rec", "ring_overwrote_dead_rec"):
        metrics[k] = torch.stack([m[k] for m in per])          # [n, Rl]
    metrics["ring_occ_max"] = torch.stack(
        [m["ring_occ_max"] for m in per]).max()
    # per-shard means weight hash-padding records with 0 occupancy;
    # renormalise to the real record count
    metrics["ring_occ_mean"] = torch.stack(
        [m["ring_occ_mean"] for m in per]).sum() \
        * store.records_per_shard / store.num_records
    if store.paged:
        for k in ("paged_alloc_failed", "paged_pages_allocated",
                  "paged_pages_free"):
            metrics[k] = total(k)
    new_spill = None
    if store.spill is not None:
        for k in ("spill_freed", "spill_admitted", "spill_dropped",
                  "spill_overwrote", "spill_overwrote_pinned",
                  "spill_occupancy"):
            metrics[k] = total(k)
        new_spill = _stack(spills)
    return dataclasses.replace(_with_primary(store, _stack(prims)),
                               spill=new_spill), metrics


def gc_sharded(store: ShardedVersionStore, watermark
               ) -> Tuple[ShardedVersionStore, torch.Tensor]:
    """Standalone watermark GC sweep over the primary and the spill pool
    (see ``gc_ring`` / ``gc_pages`` / ``gc_spill``). The paged sweep also
    returns fully drained stranded pages to the free list."""
    if store.rings is not None:
        prim, evicted = gc_ring(store.rings, watermark)
    else:
        swept = [gc_pages(_take_shard(store, s), watermark, store.k_eff[s])
                 for s in range(store.n_shards)]
        prim = _stack([slab for slab, _ in swept])
        evicted = torch.stack([e for _, e in swept]).sum(dtype=torch.int32)
    spill = store.spill
    if spill is not None:
        spill, freed = gc_spill(spill, watermark)
        evicted = evicted + freed
    return dataclasses.replace(_with_primary(store, prim),
                               spill=spill), evicted


# ---------------------------------------------------------------------------
# Snapshot reads: mvcc_resolve over the ring in place (or mvcc_resolve_paged
# over the slab), then the spill fall-through through mvcc_resolve_masked
# over the pool in place, the primary's result passed in as its prior.
# ---------------------------------------------------------------------------
def gather_windows_sharded(store: ShardedVersionStore,
                           records: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(begin [B, K], end [B, K], payload [B, K, D]) primary windows. For
    a paged store they are materialised through the page table (K =
    MaxP * S, unmapped pages give empty slots) — a diagnostic path; reads
    go through ``mvcc_resolve_paged``."""
    n = store.n_shards
    rec = records.to(torch.int32).clamp(min=0).long()
    shard = rec % n
    # an id past the store reads its shard's last row, as the
    # reference's clamped gathers do
    loc = torch.div(rec, n, rounding_mode="floor").clamp(
        max=store.records_per_shard - 1)
    if store.paged:
        p = store.pages
        pt = p.page_table[shard, loc]                          # [B, MaxP]
        safe = pt.clamp(min=0).long()
        sh = shard[:, None]
        return mask_gathered_windows(pt, p.begin[sh, safe], p.end[sh, safe],
                                     p.payload[sh, safe])
    r = store.rings
    return r.begin[shard, loc], r.end[shard, loc], r.payload[shard, loc]


def _resolve_two_level(prim_s, spill_s: Optional[SpillPool],
                       rows: torch.Tensor, want: torch.Tensor,
                       ts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary resolve with the spill fall-through: a version leaves the
    primary exactly when it moves to spill and [begin, end) windows
    partition a record's timeline, so at most one level holds the
    version visible at ``ts`` and combining is a select. ``rows`` are the
    reads' shard-local record ids clamped to [0, Rl - 1], ``want`` the
    same ids unclamped (the spill pool's owner test), as in the
    reference. The primary is read in place: a dense ring's rows through
    ``mvcc_resolve(rows=)``, a page slab through its page table's rows
    and ``mvcc_resolve_paged(rows=)``; the spill bucket is read in place
    by ``mvcc_resolve_masked``, which takes the primary's result as its
    prior and makes the select: two launches a shard, no copy."""
    if isinstance(prim_s, PageSlab):
        vals, found = ops.mvcc_resolve_paged(prim_s.page_table, prim_s.begin,
                                             prim_s.end, prim_s.payload, ts,
                                             rows=rows)
    else:
        vals, found = ops.mvcc_resolve(prim_s.begin, prim_s.end,
                                       prim_s.payload, ts, rows=rows)
    if spill_s is None:
        return vals, found
    return ops.mvcc_resolve_masked(spill_s.begin, spill_s.end, spill_s.rec,
                                   want, spill_s.payload, ts, in_place=True,
                                   prior=(vals, found))


def resolve_sharded(store: ShardedVersionStore, records: torch.Tensor,
                    ts: torch.Tensor, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve ``records`` [B] at snapshot timestamps ``ts`` [B] through
    the kernels, primary level then spill, once per shard; results merge
    by ownership. An id past the store reads its shard's last row and a
    negative one row 0, as the reference's clamped gathers do; the spill
    pool's owner test takes the id unclamped above, so it never matches
    there. Returns (vals [B, D], found [B])."""
    if mesh is not None:
        raise _unported("the mesh= substrate")
    n, last = store.n_shards, store.records_per_shard - 1
    records = records.to(torch.int32)
    ts = ts.to(torch.int32).contiguous()
    if n == 1:
        local = records.clamp(min=0).contiguous()
        return _resolve_two_level(_ring0(store), _take_spill(store, 0),
                                  local.clamp(max=last), local, ts)
    # a read's shard-local id is the same for every shard: a shard that
    # does not own the read resolves it too, and the merge drops that
    # result
    owner = records % n
    local = torch.div(records, n, rounding_mode="floor")
    rows = local.clamp(0, last)
    vals = found = None
    for s in range(n):
        owned = owner == s
        v_s, f_s = _resolve_two_level(_take_shard(store, s),
                                      _take_spill(store, s), rows, local,
                                      ts)
        v_s = torch.where(owned[:, None], v_s, 0)
        f_s = owned & f_s
        # each read has exactly one owner: the sum is a select
        vals = v_s if vals is None else vals + v_s
        found = f_s if found is None else found | f_s
    return vals, found
