"""Paged physical version storage: a page-slab allocator for the rings.

The port of ``repro.store.pages``. The dense primary store allocates
every record's ring at the physical slot ceiling ``k_max``; the paged
store replaces the dense ``[R, K]`` ring arrays with

    begin      [P, S] i32    slab: page-major version slots (INF = empty)
    end        [P, S] i32
    payload    [P, S, D]
    page_table [R, MaxP] i32 per-record page ids (-1 = unmapped)
    head       [R]    i32    logical insert cursor (mod k_eff, as dense)

where ``P`` (the slab page count) is a real physical budget: a cold
record holds ONE page (its initial version) and hot records grow by
whole pages granted from a free list.

The LOGICAL semantics are exactly the dense ring's: record ``r`` owns
logical slots ``[0, MaxP * S)``; insertion is ring arithmetic
``(head + rank) % k_eff`` over logical slots; logical slot ``j`` is
backed by physical slot ``page_table[r, j // S] * S + j % S``. So a paged
store answers every read byte-identically to a dense ring store with the
same ``k_eff`` trajectory; the one new loss mode is free-list exhaustion,
which drops the unplaceable versions (counted under
``paged_alloc_failed``, offered to spill, and a later read reports
``found=False``, never a stale payload).

Page allocation is deterministic and stateless: per commit, page
requests (record, page-index) in row-major order take free pages (pages
referenced by no table entry) in ascending page-id order — one cumsum and
one stable sort, no allocator state. Reclamation is two-level: the
watermark sweep frees SLOTS (``end <= watermark``, freed slots zeroed)
and ``gc_pages`` returns whole PAGES to the free list when every slot is
free and the page sits beyond the record's capacity ``ceil(k_eff / S)``.

Translation notes: as in ``repro_torch.store.ring``, every
``.at[idx].op(mode="drop")`` of the reference is a scatter into a copy
padded with one sentinel row (index ``n`` is the dropped entry) that is
sliced off; targets of the sets are distinct (a page has one owner, a
landed insert one slot). The reference's stable argsorts are
``torch.sort(stable=True)``. The hot read path is the ``mvcc_resolve_paged``
kernel (``repro_torch.kernels``), which reads the slab through page-table
rows and never builds the windows ``gather_windows_paged`` returns.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.store.ring import (INF_TS, i32, isum, pin_stabbed,
                                    scatter_count, scatter_set)


@dataclasses.dataclass(frozen=True)
class PageSlab:
    begin: torch.Tensor       # [P, S] i32, INF_TS = empty slot
    end: torch.Tensor         # [P, S] i32
    payload: torch.Tensor     # [P, S, D]
    page_table: torch.Tensor  # [R, MaxP] i32 page ids, -1 = unmapped
    head: torch.Tensor        # [R] i32 logical insert cursor

    # negative indices: the same properties read correctly on a stacked
    # [n, ...] slab (repro_torch.store.sharded) and on one shard's slab
    @property
    def num_pages(self) -> int:
        return self.begin.shape[-2]

    @property
    def page_slots(self) -> int:
        return self.begin.shape[-1]

    @property
    def num_records(self) -> int:
        return self.page_table.shape[-2]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[-1]

    @property
    def num_slots(self) -> int:
        """Logical slot ceiling per record (the dense store's K)."""
        return self.max_pages * self.page_slots


def scatter_add(n: int, idx: torch.Tensor, src: torch.Tensor
                ) -> torch.Tensor:
    """``zeros(n).at[idx].add(src, mode="drop")`` with index ``n`` as the
    dropped entry (int32)."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx.long(), src.to(torch.int32))
    return out[:n]


def init_page_slab(base: torch.Tensor, base_ts: torch.Tensor,
                   real: torch.Tensor, num_pages: int, page_slots: int,
                   max_pages: int) -> PageSlab:
    """One shard's slab: real record ``r`` maps page ``r`` whose slot 0
    holds the initial open version (hash-padding records map nothing).
    Requires ``num_pages >= num_records``."""
    R, D = base.shape
    P, S = int(num_pages), int(page_slots)
    if P < R:
        raise ValueError("pages_per_shard must be >= records per shard "
                         "(each record holds at least its initial page)")
    dev = base.device
    real = real.to(torch.bool)
    begin = torch.full((P, S), INF_TS, dtype=torch.int32, device=dev)
    begin[:R, 0] = torch.where(real, base_ts.to(torch.int32), INF_TS)
    end = torch.full((P, S), INF_TS, dtype=torch.int32, device=dev)
    payload = torch.zeros((P, S, D), dtype=base.dtype, device=dev)
    payload[:R, 0, :] = torch.where(real[:, None], base, 0)
    page_table = torch.full((R, int(max_pages)), -1, dtype=torch.int32,
                            device=dev)
    page_table[:, 0] = torch.where(
        real, torch.arange(R, dtype=torch.int32, device=dev), -1)
    head = torch.full((R,), 1 % (int(max_pages) * S), dtype=torch.int32,
                      device=dev)
    return PageSlab(begin=begin, end=end, payload=payload,
                    page_table=page_table, head=head)


def page_owner_index(page_table: torch.Tensor, num_pages: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the page table: (owner [P] record id or -1, pidx [P] the
    page's index within its owner's table). Ownership is always derived
    from the table, never stored."""
    R, MaxP = page_table.shape
    dev = page_table.device
    pt = page_table.reshape(-1)
    rec = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(
        R, MaxP).reshape(-1)
    idx = torch.arange(MaxP, dtype=torch.int32, device=dev)[None, :].expand(
        R, MaxP).reshape(-1)
    tgt = torch.where(pt >= 0, pt, num_pages)
    empty = torch.full((num_pages,), -1, dtype=torch.int32, device=dev)
    return scatter_set(empty, tgt, rec), scatter_set(empty, tgt, idx)


def mapped_page_count(slab: PageSlab) -> torch.Tensor:
    """[] number of pages currently referenced by the page table."""
    return isum(slab.page_table >= 0)


def free_page_count(slab: PageSlab) -> torch.Tensor:
    """[] pages available to the allocator."""
    return slab.num_pages - mapped_page_count(slab)


def slab_fill_fraction(slab: PageSlab) -> torch.Tensor:
    """[] mapped fraction of the slab in [0, 1] — the allocator
    saturation gauge (at 1.0 further version placements fail)."""
    return mapped_page_count(slab) / float(max(slab.num_pages, 1))


def paged_occupancy(slab: PageSlab) -> torch.Tensor:
    """[R] live (non-garbage) version count per record — the paged twin
    of ``ring_occupancy``."""
    owner, _ = page_owner_index(slab.page_table, slab.num_pages)
    per_page = (slab.begin != INF_TS).sum(1, dtype=torch.int32)
    R = slab.num_records
    return scatter_add(R, torch.where(owner >= 0, owner, R), per_page)


def mask_gathered_windows(pt: torch.Tensor, begin_g: torch.Tensor,
                          end_g: torch.Tensor, payload_g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Per-read gathered page windows -> flat dense-shaped candidate
    windows: pt [B, MaxP] (-1 = unmapped), begin_g/end_g [B, MaxP, S],
    payload_g [B, MaxP, S, D] -> (begin [B, MaxP*S], end,
    payload [B, MaxP*S, D]) with unmapped pages' slots emptied."""
    mapped = (pt >= 0)[..., None]                      # [B, MaxP, 1]
    B, MaxP = pt.shape
    S = begin_g.shape[-1]
    begin = torch.where(mapped, begin_g, INF_TS)
    end = torch.where(mapped, end_g, INF_TS)
    payload = torch.where(mapped[..., None], payload_g, 0)
    return (begin.reshape(B, MaxP * S), end.reshape(B, MaxP * S),
            payload.reshape(B, MaxP * S, -1))


def gather_windows_paged(slab: PageSlab, records: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Materialise per-read candidate windows through the page table:
    records [B] -> (begin [B, MaxP*S], end, payload [B, MaxP*S, D]).
    Ids are clamped to [0, R - 1], as the reference's gather is.
    Diagnostic path; reads go through the ``mvcc_resolve_paged`` kernel."""
    rec = records.to(torch.int32).clamp(
        0, slab.page_table.shape[0] - 1).long()
    pt = slab.page_table[rec]                          # [B, MaxP]
    safe = pt.clamp(min=0).long()
    return mask_gathered_windows(pt, slab.begin[safe], slab.end[safe],
                                 slab.payload[safe])


def commit_paged(slab: PageSlab, w_rec: torch.Tensor, w_key: torch.Tensor,
                 w_valid: torch.Tensor, w_begin_ts: torch.Tensor,
                 w_end_ts: torch.Tensor, w_data: torch.Tensor, watermark,
                 ts_window: Optional[Tuple] = None,
                 k_eff: Optional[torch.Tensor] = None,
                 pin_ts: Optional[torch.Tensor] = None,
                 with_evictees: bool = False,
                 with_audit: bool = False
                 ) -> Tuple[PageSlab, Dict[str, torch.Tensor]]:
    """The paged twin of ``commit_versions``: same contract, same metric
    keys, plus the allocator's counters (``paged_alloc_failed``,
    ``paged_pages_allocated``, ``paged_pages_free``):

      1. reclaim every version with end <= (clamped) watermark;
      2. close the previously-open head version of each written record;
      3. insert at logical ring positions (head + rank) % k_eff,
         allocating pages from the free list for logical pages the record
         does not map yet (requests in (record, page-index) order take
         free pages in ascending id order).

    A version whose page request cannot be satisfied is dropped like a
    within-batch ring overflow: counted, its liveness assessed
    pin-precisely and, with ``with_evictees``, offered to the spill tier.
    """
    if with_audit:
        raise NotImplementedError(
            "with_audit lifecycle taps are not ported yet (ROADMAP.md, "
            "queue 1 slice E)")
    P, S = slab.begin.shape
    R, MaxP = slab.page_table.shape
    dev = slab.begin.device
    watermark = i32(watermark, dev)
    if ts_window is not None:
        watermark = torch.minimum(watermark, i32(ts_window[0], dev))
    k_arr = (torch.full((R,), MaxP * S, dtype=torch.int32, device=dev)
             if k_eff is None else k_eff.to(torch.int32))
    floor = (i32(ts_window[1], dev) - 1 if ts_window is not None
             else watermark)

    # -- 1. precise reclamation below the watermark (slab-wide; freed
    #       slots fully zeroed so a drained page is byte-identical free) --
    live = slab.begin != INF_TS
    dead = live & (slab.end <= watermark)
    evicted = isum(dead)
    begin = torch.where(dead, INF_TS, slab.begin)
    end = torch.where(dead, INF_TS, slab.end)
    payload = torch.where(dead[..., None], 0, slab.payload)

    # -- 2. close the open head version of every written record ------------
    first_ts = torch.full((R + 1,), INF_TS, dtype=torch.int32, device=dev)
    first_ts.scatter_reduce_(
        0, torch.where(w_valid, w_rec, R).long(),
        torch.where(w_valid, w_begin_ts, INF_TS), reduce="amin",
        include_self=True)
    first_ts = first_ts[:R]
    owner, _ = page_owner_index(slab.page_table, P)
    ft_page = torch.where(owner >= 0, first_ts[owner.clamp(0, R - 1).long()],
                          INF_TS)
    open_slot = (end == INF_TS) & (begin != INF_TS)
    end = torch.where(open_slot & (ft_page != INF_TS)[:, None],
                      ft_page[:, None], end)

    # -- 3. insert at logical ring positions -------------------------------
    order = torch.sort(w_key, stable=True).indices  # record-major, pads last
    rec_s = w_rec[order].contiguous()
    valid_s = w_valid[order]
    beg_s = w_begin_ts[order]
    end_s = w_end_ts[order]
    data_s = w_data[order]

    left = torch.searchsorted(rec_s, rec_s, side="left").to(torch.int32)
    right = torch.searchsorted(rec_s, rec_s, side="right").to(torch.int32)
    count = right - left
    rank = torch.arange(rec_s.shape[0], dtype=torch.int32,
                        device=dev) - left
    safe_rec = rec_s.clamp(0, R - 1)
    rec_l = safe_rec.long()
    k_rec = k_arr[rec_l]
    drop_n = (count - k_rec).clamp(min=0)          # overflow: drop oldest
    keep = valid_s & (rank >= drop_n)
    # kept entries have rank >= drop_n; the clamp keeps the operand
    # non-negative for dropped ones, which never land
    lslot = (slab.head[rec_l] + (rank - drop_n).clamp(min=0)) % k_rec
    lpage = (lslot // S).clamp(max=MaxP - 1).long()  # in-bound when
    #                                                  k_eff <= MaxP * S

    # -- page allocation: the free list as a sorted index pass -------------
    # requests = (record, page-index) cells some kept insert lands in and
    # the table does not map; the q-th request (row-major table order)
    # takes the q-th free page (ascending id) — stateless and replayable
    need = keep & (slab.page_table[rec_l, lpage] < 0)
    req = torch.zeros((R + 1, MaxP), dtype=torch.bool, device=dev)
    req[torch.where(need, safe_rec, R).long(), lpage] = True
    pt_flat = slab.page_table.reshape(-1)
    used = scatter_set(torch.zeros((P,), dtype=torch.bool, device=dev),
                       torch.where(pt_flat >= 0, pt_flat, P),
                       torch.ones_like(pt_flat, dtype=torch.bool))
    n_free = isum(~used)
    free_ids = torch.sort(used.to(torch.int32), stable=True).indices
    req_flat = req[:R].reshape(-1)
    req_rank = torch.cumsum(req_flat, 0) - 1
    granted = req_flat & (req_rank < n_free)
    grant_page = torch.where(granted, free_ids[req_rank.clamp(0, P - 1)], -1)
    page_table = torch.where(granted.reshape(R, MaxP),
                             grant_page.reshape(R, MaxP).to(torch.int32),
                             slab.page_table)

    pid = page_table[rec_l, lpage]
    landed = keep & (pid >= 0)
    flat = torch.where(landed, pid * S + lslot % S, P * S)  # P*S => dropped
    safe_flat = flat.clamp(max=P * S - 1).long()
    tgt_begin = begin.reshape(-1)[safe_flat]
    tgt_end = end.reshape(-1)[safe_flat]
    # pin-precise liveness of what this insert destroys
    hit_any = landed & (tgt_begin != INF_TS)
    tgt_live = (tgt_end > floor) | pin_stabbed(tgt_begin, tgt_end, pin_ts)
    hit_live = hit_any & tgt_live
    hit_dead = hit_any & ~tgt_live

    # never-inserted versions (ring overflow + allocation failures) face
    # the same pin-precise liveness test
    dropped = valid_s & ~landed
    drop_live = dropped & ((end_s > floor)
                           | pin_stabbed(beg_s, end_s, pin_ts))
    drop_dead = dropped & ~drop_live

    metrics_ev = {}
    if with_evictees:
        # the reclaimed (zeroed) slab's contents of the destroyed slots,
        # gathered BEFORE the scatter (targets are distinct)
        tgt_payload = payload.reshape(P * S, -1)[safe_flat]
        metrics_ev = dict(
            evict_rec=torch.cat([safe_rec, safe_rec]),
            evict_begin=torch.cat([tgt_begin, beg_s]),
            evict_end=torch.cat([tgt_end, end_s]),
            evict_payload=torch.cat([tgt_payload, data_s]),
            evict_valid=torch.cat([hit_live, drop_live]))

    begin = scatter_set(begin.reshape(-1), flat, beg_s).reshape(P, S)
    end = scatter_set(end.reshape(-1), flat, end_s).reshape(P, S)
    payload = scatter_set(payload.reshape(P * S, -1), flat,
                          data_s).reshape(slab.payload.shape)

    inserted = scatter_count(R, torch.where(w_valid, w_rec, R))
    head = (slab.head + torch.minimum(inserted, k_arr)) % k_arr

    new_slab = PageSlab(begin=begin, end=end, payload=payload,
                        page_table=page_table, head=head)
    occ = paged_occupancy(new_slab)
    n_granted = isum(granted)
    metrics = {
        "ring_evicted": evicted,
        "ring_overflow_dropped": isum(valid_s & ~keep),
        "ring_overwrote_live": isum(hit_live) + isum(drop_live),
        "ring_overwrote_dead": isum(hit_dead) + isum(drop_dead),
        "ring_overwrote_rec": scatter_count(
            R, torch.where(hit_live, safe_rec, R)) + scatter_count(
            R, torch.where(drop_live, safe_rec, R)),
        "ring_overwrote_dead_rec": scatter_count(
            R, torch.where(hit_dead, safe_rec, R)) + scatter_count(
            R, torch.where(drop_dead, safe_rec, R)),
        "ring_occ_max": occ.max(),
        "ring_occ_mean": occ.to(torch.float32).mean(),
        "paged_alloc_failed": isum(keep & ~landed),
        "paged_pages_allocated": n_granted,
        "paged_pages_free": n_free - n_granted,
    }
    metrics.update(metrics_ev)
    return new_slab, metrics


def gc_pages(slab: PageSlab, watermark, k_eff: torch.Tensor
             ) -> Tuple[PageSlab, torch.Tensor]:
    """Two-level standalone sweep: free every SLOT with ``end <=
    watermark`` (freed slots zeroed), then return to the free list every
    PAGE that is fully free AND beyond its owner's capacity
    ``ceil(k_eff / S)`` — the pages a policy shrink stranded. Returns
    (slab, freed version count); the count equals the dense ``gc_ring``'s,
    page returns are a physical-layout event with no logical content."""
    watermark = i32(watermark, slab.begin.device)
    S = slab.page_slots
    dead = (slab.begin != INF_TS) & (slab.end <= watermark)
    begin = torch.where(dead, INF_TS, slab.begin)
    end = torch.where(dead, INF_TS, slab.end)
    payload = torch.where(dead[..., None], 0, slab.payload)

    owner, pidx = page_owner_index(slab.page_table, slab.num_pages)
    empty = (begin == INF_TS).all(dim=1)                       # [P]
    pages_needed = torch.div(k_eff.to(torch.int32) + S - 1, S,
                             rounding_mode="floor")            # ceil
    stranded = (owner >= 0) & empty & (
        pidx >= pages_needed[owner.clamp(0, slab.num_records - 1).long()])
    # unmap: a table entry is cleared exactly when its page is stranded
    strand_pos = (slab.page_table >= 0) & stranded[
        slab.page_table.clamp(0, slab.num_pages - 1).long()]
    page_table = torch.where(strand_pos, -1, slab.page_table)
    return PageSlab(begin=begin, end=end, payload=payload,
                    page_table=page_table, head=slab.head), isum(dead)
