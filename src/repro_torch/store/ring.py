"""Single-shard persistent version ring: per-record slots + precise GC.

The port of ``repro.store.ring``: a fixed-K per-record version ring that
persists across batch barriers,

    begin   [R, K] i32   version begin timestamp (INF_TS = empty slot)
    end     [R, K] i32   version end timestamp   (INF_TS = still open)
    payload [R, K, D]    version payloads
    head    [R]    i32   next ring position (insert cursor, mod K)

reclaimed by the low watermark (paper §4.2.2 conditions 1+2: a version
dies when ``end <= watermark``). Slots are unsorted; the ``mvcc_resolve``
kernel's interval test is order-independent, so the j-th new version of
record r in a batch lands in slot (head[r] + j) % K. Overflow keeps the
newest ``k_eff[r]`` versions; eviction liveness is pin-precise
(``pin_stabbed``), and live evictees can be handed to the spill tier
(``with_evictees=True``).

Translation notes: the reference's ``.at[idx].op(mode="drop")`` scatters
become scatters into a copy padded with one sentinel row that is sliced
off afterwards, so out-of-range (masked) entries never need a host-side
compaction; commit targets are distinct, so write order does not matter.
Every sort that the reference makes stable is ``torch.sort(stable=True)``.
Every ``%`` and ``//`` here has non-negative operands, where floor
modulo (jnp) and torch's tensor ``%`` agree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

INF_TS = 2 ** 31 - 1     # int32 max: empty slot / still-open version

# Version-lifecycle audit state codes, stamped on the device by the
# commit paths when ``with_audit=True`` (``repro_torch.obs.lifecycle``
# re-exports them; the store does not import the obs layer). Code 0 =
# masked / no event.
AUDIT_COMMITTED = 1
AUDIT_OVERWROTE_LIVE = 2
AUDIT_OVERWROTE_DEAD = 3
AUDIT_SPILLED = 4
AUDIT_SPILL_DROPPED = 5
AUDIT_SPILL_OVERWROTE = 6
AUDIT_PAGE_DROPPED = 7
AUDIT_GC_RECLAIMED = 8

AUDIT_STATE_NAMES = {
    AUDIT_COMMITTED: "committed",
    AUDIT_OVERWROTE_LIVE: "overwritten_live",
    AUDIT_OVERWROTE_DEAD: "overwritten_dead",
    AUDIT_SPILLED: "spilled",
    AUDIT_SPILL_DROPPED: "spill_dropped",
    AUDIT_SPILL_OVERWROTE: "spill_overwritten",
    AUDIT_PAGE_DROPPED: "page_dropped",
    AUDIT_GC_RECLAIMED: "gc_reclaimed",
}


def i32(x, device) -> torch.Tensor:
    """An int32 tensor (scalar or array) on ``device``."""
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def scatter_set(dst: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")`` along dim 0, where every
    index equal to ``len(dst)`` is a dropped (masked) entry: the write
    goes to one sentinel row that is sliced off. Returns a new tensor."""
    pad = torch.zeros((1,) + dst.shape[1:], dtype=dst.dtype,
                      device=dst.device)
    ext = torch.cat([dst, pad])
    ext[idx.long()] = src
    return ext[:-1]


def scatter_count(n: int, idx: torch.Tensor) -> torch.Tensor:
    """``zeros(n).at[idx].add(1, mode="drop")`` with index ``n`` as the
    dropped entry: an int32 [n] histogram."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx.long(), torch.ones_like(idx, dtype=torch.int32))
    return out[:n]


def isum(x: torch.Tensor) -> torch.Tensor:
    """Count/sum as an int32 scalar (the reference's ``jnp.sum`` dtype)."""
    return x.sum(dtype=torch.int32)


def pin_stabbed(begin: torch.Tensor, end: torch.Tensor,
                pin_ts: Optional[torch.Tensor]) -> torch.Tensor:
    """Elementwise: does any registered snapshot pin land inside
    [begin, end)?  ``pin_ts`` is a [P] i32 tensor padded with INF_TS (a
    pad pin never stabs a closed version). ``None`` stabs nothing."""
    if pin_ts is None:
        return torch.zeros(begin.shape, dtype=torch.bool,
                           device=begin.device)
    p = pin_ts.reshape((1,) * begin.dim() + (-1,))
    return ((begin[..., None] <= p) & (p < end[..., None])).any(-1)


@dataclasses.dataclass(frozen=True)
class VersionRing:
    begin: torch.Tensor     # [R, K] i32
    end: torch.Tensor       # [R, K] i32
    payload: torch.Tensor   # [R, K, D]
    head: torch.Tensor      # [R] i32

    @property
    def num_slots(self) -> int:
        return self.begin.shape[-1]

    @property
    def num_records(self) -> int:
        return self.begin.shape[-2]


def init_ring(base: torch.Tensor, base_ts, num_slots: int = 4
              ) -> VersionRing:
    """Ring whose slot 0 holds the initial open version of every record."""
    R, D = base.shape
    dev = base.device
    begin = torch.full((R, num_slots), INF_TS, dtype=torch.int32,
                       device=dev)
    begin[:, 0] = i32(base_ts, dev)
    end = torch.full((R, num_slots), INF_TS, dtype=torch.int32, device=dev)
    payload = torch.zeros((R, num_slots, D), dtype=base.dtype, device=dev)
    payload[:, 0, :] = base
    head = torch.full((R,), 1 % num_slots, dtype=torch.int32, device=dev)
    return VersionRing(begin=begin, end=end, payload=payload, head=head)


def ring_occupancy(ring: VersionRing) -> torch.Tensor:
    """[R] live (non-garbage) version count per record."""
    return (ring.begin != INF_TS).sum(-1, dtype=torch.int32)


def ring_fill_fraction(occupancy: torch.Tensor,
                       k_eff: torch.Tensor) -> torch.Tensor:
    """Per-record ring pressure in [0, 1]: live versions over effective
    capacity (elementwise on [R] or stacked [n, Rl] inputs)."""
    return occupancy / k_eff.clamp(min=1).to(torch.float32)


def gather_windows(ring: VersionRing, records: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-gather per-read candidate windows for ``mvcc_resolve``'s
    windows form: records [B] -> (begin [B, K], end [B, K], payload
    [B, K, D]). Ids are clamped to [0, R - 1], as the reference's gather
    is. A diagnostic path: reads take the ring in place
    (``mvcc_resolve(..., rows=)``)."""
    rec = records.to(torch.int32).clamp(0, ring.begin.shape[0] - 1).long()
    return ring.begin[rec], ring.end[rec], ring.payload[rec]


def commit_versions(ring: VersionRing, w_rec: torch.Tensor,
                    w_key: torch.Tensor, w_valid: torch.Tensor,
                    w_begin_ts: torch.Tensor, w_end_ts: torch.Tensor,
                    w_data: torch.Tensor, watermark,
                    ts_window: Optional[Tuple] = None,
                    k_eff: Optional[torch.Tensor] = None,
                    pin_ts: Optional[torch.Tensor] = None,
                    with_evictees: bool = False,
                    with_audit: bool = False
                    ) -> Tuple[VersionRing, Dict[str, torch.Tensor]]:
    """Batch-barrier ring maintenance: GC conditions 1+2, then commit ALL
    of the batch's versions (see ``repro.store.ring.commit_versions`` for
    the full contract — the arguments, clamps and metrics are the same).

      1. reclaim every version with end <= watermark;
      2. close the previously-open head version of each written record;
      3. insert the batch's versions at (head + rank) % k_eff, keeping
         the newest k_eff per record when a segment overflows the ring.

    ``w_key`` is the plan's int64 (record, ts) key (same order as the
    reference's uint32 key, pads 0xFFFFFFFF). ``with_audit=True`` adds
    ``ring_committed`` and the lifecycle tap's [3N] ``audit_rec`` /
    ``audit_begin`` / ``audit_end`` / ``audit_state`` arrays (insert,
    eviction victim, overflow drop per sorted placeholder; state 0 where
    masked)."""
    R, K = ring.begin.shape
    dev = ring.begin.device
    watermark = i32(watermark, dev)
    if ts_window is not None:
        watermark = torch.minimum(watermark, i32(ts_window[0], dev))
    k_arr = (torch.full((R,), K, dtype=torch.int32, device=dev)
             if k_eff is None else k_eff.to(torch.int32))
    # future readers pin at >= ts_hi - 1; without a window the floor
    # degrades to the watermark (the bare-ring liveness test)
    floor = (i32(ts_window[1], dev) - 1 if ts_window is not None
             else watermark)

    # -- 1. precise reclamation below the watermark ------------------------
    live = ring.begin != INF_TS
    dead = live & (ring.end <= watermark)          # open versions: end==INF
    evicted = isum(dead)
    begin = torch.where(dead, INF_TS, ring.begin)
    end = torch.where(dead, INF_TS, ring.end)

    # -- 2. close the open head version of every written record ------------
    first_ts = torch.full((R + 1,), INF_TS, dtype=torch.int32, device=dev)
    first_ts.scatter_reduce_(
        0, torch.where(w_valid, w_rec, R).long(),
        torch.where(w_valid, w_begin_ts, INF_TS), reduce="amin",
        include_self=True)
    first_ts = first_ts[:R]
    open_slot = (end == INF_TS) & (begin != INF_TS)
    end = torch.where(open_slot & (first_ts != INF_TS)[:, None],
                      first_ts[:, None], end)

    # -- 3. insert the batch's versions (newest k_eff[r] per record) -------
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
    k_rec = k_arr[safe_rec.long()]                 # per-record capacity
    drop_n = (count - k_rec).clamp(min=0)          # overflow: drop oldest
    keep = valid_s & (rank >= drop_n)
    # kept entries have rank >= drop_n; the clamp keeps the operand
    # non-negative for dropped ones too, which never reach the scatter
    slot = (ring.head[safe_rec.long()] + (rank - drop_n).clamp(min=0)) \
        % k_rec
    flat = torch.where(keep, safe_rec * K + slot, R * K)  # R*K => dropped

    safe_flat = flat.clamp(max=R * K - 1).long()
    tgt_begin = begin.reshape(-1)[safe_flat]
    tgt_end = end.reshape(-1)[safe_flat]
    # pin-precise liveness of what this insert destroys
    hit_any = keep & (tgt_begin != INF_TS)
    tgt_live = (tgt_end > floor) | pin_stabbed(tgt_begin, tgt_end, pin_ts)
    hit_live = hit_any & tgt_live
    hit_dead = hit_any & ~tgt_live
    overwrote_rec = scatter_count(R, torch.where(hit_live, safe_rec, R))
    overwrote_dead_rec = scatter_count(R, torch.where(hit_dead, safe_rec, R))

    # within-batch overflow drops (never inserted) face the same test
    dropped = valid_s & ~keep
    drop_live = dropped & ((end_s > floor)
                           | pin_stabbed(beg_s, end_s, pin_ts))
    drop_dead = dropped & ~drop_live

    metrics_ev = {}
    if with_evictees:
        # old contents of the destroyed slots, gathered BEFORE the scatter
        # (targets are distinct), plus the live within-batch drops
        tgt_payload = ring.payload.reshape(R * K, -1)[safe_flat]
        metrics_ev = dict(
            evict_rec=torch.cat([safe_rec, safe_rec]),
            evict_begin=torch.cat([tgt_begin, beg_s]),
            evict_end=torch.cat([tgt_end, end_s]),
            evict_payload=torch.cat([tgt_payload, data_s]),
            evict_valid=torch.cat([hit_live, drop_live]))

    if with_audit:
        # victim rows carry the DESTROYED version's window (gathered
        # before the scatter); drop rows the never-inserted version's own
        zero = torch.zeros_like(rec_s)
        ins_state = torch.where(valid_s, AUDIT_COMMITTED, zero)
        vic_state = torch.where(hit_live, AUDIT_OVERWROTE_LIVE,
                                torch.where(hit_dead, AUDIT_OVERWROTE_DEAD,
                                            zero))
        drop_state = torch.where(drop_live, AUDIT_OVERWROTE_LIVE,
                                 torch.where(drop_dead,
                                             AUDIT_OVERWROTE_DEAD, zero))
        metrics_ev.update(
            ring_committed=isum(valid_s),
            audit_rec=torch.cat([safe_rec, safe_rec, safe_rec]),
            audit_begin=torch.cat([beg_s, tgt_begin, beg_s]),
            audit_end=torch.cat([end_s, tgt_end, end_s]),
            audit_state=torch.cat([ins_state, vic_state, drop_state]))

    begin = scatter_set(begin.reshape(-1), flat, beg_s).reshape(R, K)
    end = scatter_set(end.reshape(-1), flat, end_s).reshape(R, K)
    payload = scatter_set(ring.payload.reshape(R * K, -1), flat,
                          data_s).reshape(ring.payload.shape)

    inserted = scatter_count(R, torch.where(w_valid, w_rec, R))
    head = (ring.head + torch.minimum(inserted, k_arr)) % k_arr

    new_ring = VersionRing(begin=begin, end=end, payload=payload, head=head)
    occ = ring_occupancy(new_ring)
    metrics = {
        "ring_evicted": evicted,
        "ring_overflow_dropped": isum(dropped),
        "ring_overwrote_live": isum(hit_live) + isum(drop_live),
        "ring_overwrote_dead": isum(hit_dead) + isum(drop_dead),
        "ring_overwrote_rec": overwrote_rec + scatter_count(
            R, torch.where(drop_live, safe_rec, R)),
        "ring_overwrote_dead_rec": overwrote_dead_rec + scatter_count(
            R, torch.where(drop_dead, safe_rec, R)),
        "ring_occ_max": occ.max(),
        "ring_occ_mean": occ.to(torch.float32).mean(),
    }
    metrics.update(metrics_ev)
    return new_ring, metrics


def gc_ring(ring: VersionRing, watermark
            ) -> Tuple[VersionRing, torch.Tensor]:
    """Standalone precise GC sweep: reclaim every version with
    ``end <= watermark``, touching nothing else. Returns (ring, evicted
    count). Works elementwise on stacked [n, Rl, K] rings too."""
    watermark = i32(watermark, ring.begin.device)
    dead = (ring.begin != INF_TS) & (ring.end <= watermark)
    return VersionRing(begin=torch.where(dead, INF_TS, ring.begin),
                       end=torch.where(dead, INF_TS, ring.end),
                       payload=ring.payload,
                       head=ring.head), isum(dead)
