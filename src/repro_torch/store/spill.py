"""Secondary spill store: the overflow tier under the primary K-rings.

The port of ``repro.store.spill``. A bucketed pool of version slots
shared across records; record ``r`` spills into bucket ``r % B`` and a
read's candidates are that whole bucket, which the masked resolve kernel
reads in place (``mvcc_resolve_masked(..., in_place=True)`` computes the
bucket and filters ``rec == r``):

    begin   [B, S] i32   version begin ts (INF_TS = free slot)
    end     [B, S] i32   version end ts (spilled versions are closed)
    rec     [B, S] i32   owning record id (-1 = free)
    payload [B, S, D]

Allocation is deterministic and stateless: per commit, evictees are
placed newest-first into each bucket's slots in victim order — free
first, then unpinned oldest-first, then pinned oldest-first. A sweep
frees every slot with ``end <= watermark`` and zeroes it, so a drained
pool is bit-identical to ``init_spill_pool``.

The reference sorts uint32 keys; the port sorts int64 keys holding the
same unsigned values, so every stable sort orders identically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.store.ring import (INF_TS, i32, isum, pin_stabbed,
                                    scatter_set)

_U32 = 0xFFFFFFFF


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 holding the value's uint32 reinterpretation."""
    return x.to(torch.int64) & _U32


@dataclasses.dataclass(frozen=True)
class SpillPool:
    begin: torch.Tensor     # [B, S] i32, INF_TS = free
    end: torch.Tensor       # [B, S] i32
    rec: torch.Tensor       # [B, S] i32, -1 = free (shard-local record id)
    payload: torch.Tensor   # [B, S, D]

    @property
    def num_buckets(self) -> int:
        return self.begin.shape[-2]

    @property
    def num_slots(self) -> int:
        return self.begin.shape[-1]


def init_spill_pool(num_buckets: int, num_slots: int, payload_words: int,
                    dtype=torch.int32, device=None) -> SpillPool:
    """All-free pool (zeroed payloads — the state a full drain restores)."""
    B, S = int(num_buckets), int(num_slots)
    return SpillPool(
        begin=torch.full((B, S), INF_TS, dtype=torch.int32, device=device),
        end=torch.full((B, S), INF_TS, dtype=torch.int32, device=device),
        rec=torch.full((B, S), -1, dtype=torch.int32, device=device),
        payload=torch.zeros((B, S, payload_words), dtype=dtype,
                            device=device))


def spill_occupancy(pool: SpillPool) -> torch.Tensor:
    """[] occupied slot count."""
    return isum(pool.rec >= 0)


def spill_fill_fraction(pool: SpillPool) -> torch.Tensor:
    """[] occupied fraction of the pool in [0, 1]."""
    cap = pool.num_buckets * pool.num_slots
    return spill_occupancy(pool) / float(max(cap, 1))


def spill_buckets_for(records: torch.Tensor, num_buckets: int
                      ) -> torch.Tensor:
    """Bucket index of each (shard-local) record id — the spill hash of
    commit. Resolve computes the same rule inside
    ``mvcc_resolve_masked(..., in_place=True)`` (kernel and plain
    version); the parity tests hold the two to the reference's."""
    return records.clamp(min=0) % num_buckets


def gc_spill(pool: SpillPool, watermark) -> Tuple[SpillPool, torch.Tensor]:
    """Watermark sweep: free (and zero) every slot with
    ``end <= watermark``. Elementwise, so stacked pools work too."""
    watermark = i32(watermark, pool.begin.device)
    dead = (pool.rec >= 0) & (pool.end <= watermark)
    return SpillPool(
        begin=torch.where(dead, INF_TS, pool.begin),
        end=torch.where(dead, INF_TS, pool.end),
        rec=torch.where(dead, -1, pool.rec),
        payload=torch.where(dead[..., None], 0, pool.payload),
    ), isum(dead)


def spill_commit(pool: SpillPool, ev_rec: torch.Tensor,
                 ev_begin: torch.Tensor, ev_end: torch.Tensor,
                 ev_payload: torch.Tensor, ev_valid: torch.Tensor,
                 watermark, pin_ts: Optional[torch.Tensor] = None,
                 with_audit: bool = False
                 ) -> Tuple[SpillPool, Dict[str, torch.Tensor]]:
    """Absorb one commit's live evictees into the pool: (1) free dead
    slots at the watermark, (2) place evictees newest-first per bucket
    into victim-ordered slots, (3) report what was absorbed, overwritten
    and dropped. ``with_audit=True`` adds the lifecycle tap: each
    evictee's placement (``spill_audit_placed``) and the (rec, begin,
    end) of the spill-resident version it destroyed (``spill_victim_*``),
    in INPUT order so the caller pairs them with its ``ev_*`` arrays."""
    B, S = pool.begin.shape
    dev = pool.begin.device

    # -- 1. free dead slots so this commit's evictees can land ------------
    pool, freed = gc_spill(pool, watermark)

    # -- 2. bucket-major, newest-first evictee order (two stable sorts
    # emulate the lexsort; invalid entries get bucket B and sort last) ----
    bkt = torch.where(ev_valid, spill_buckets_for(ev_rec, B), B)
    newest_first = torch.sort(_U32 - _as_u32(ev_begin), stable=True).indices
    by_bucket = torch.sort(bkt[newest_first], stable=True).indices
    order = newest_first[by_bucket]
    bkt_s = bkt[order].contiguous()
    valid_s = ev_valid[order]
    left = torch.searchsorted(bkt_s, bkt_s, side="left")
    rank = torch.arange(bkt_s.shape[0], dtype=torch.int32,
                        device=dev) - left.to(torch.int32)

    # -- victim order per bucket: free, then unpinned (oldest first),
    #    then pinned (oldest first) — pinned history dies last ------------
    occupied = pool.rec >= 0
    pinned = occupied & pin_stabbed(pool.begin, pool.end, pin_ts)
    prio = torch.where(~occupied, 0, torch.where(~pinned, 1, 2))
    by_begin = torch.sort(_as_u32(torch.where(occupied, pool.begin, 0)),
                          dim=1, stable=True).indices
    by_prio = torch.sort(torch.gather(prio, 1, by_begin), dim=1,
                         stable=True).indices
    victim_order = torch.gather(by_begin, 1, by_prio).to(torch.int32)

    # -- 3. place: evictee with in-bucket rank r -> victim_order[bkt, r] --
    placed = valid_s & (rank < S)
    bkt_c = bkt_s.clamp(max=B - 1)
    slot = victim_order[bkt_c.long(), rank.clamp(max=S - 1).long()]
    flat = torch.where(placed, bkt_c * S + slot, B * S)
    safe = flat.clamp(max=B * S - 1).long()
    victim_occ = placed & (pool.rec.reshape(-1)[safe] >= 0)
    victim_pinned = placed & pinned.reshape(-1)[safe]

    def scatter(dst, src):
        flat_dst = dst.reshape((B * S,) + dst.shape[2:])
        return scatter_set(flat_dst, flat, src).reshape(dst.shape)

    new_pool = SpillPool(
        begin=scatter(pool.begin, ev_begin[order]),
        end=scatter(pool.end, ev_end[order]),
        rec=scatter(pool.rec, ev_rec[order]),
        payload=scatter(pool.payload, ev_payload[order]))

    metrics = {
        "spill_freed": freed,
        "spill_admitted": isum(placed),
        "spill_dropped": isum(valid_s & ~placed),
        "spill_overwrote": isum(victim_occ),
        "spill_overwrote_pinned": isum(victim_pinned),
        "spill_occupancy": spill_occupancy(new_pool),
    }
    if with_audit:
        def to_input(sorted_vals, fill):
            out = torch.full(sorted_vals.shape, fill,
                             dtype=sorted_vals.dtype, device=dev)
            out[order] = sorted_vals
            return out

        v_rec = pool.rec.reshape(-1)[safe]
        v_begin = pool.begin.reshape(-1)[safe]
        v_end = pool.end.reshape(-1)[safe]
        metrics.update(
            spill_audit_placed=to_input(placed, False),
            spill_victim_valid=to_input(victim_occ, False),
            spill_victim_rec=to_input(
                torch.where(victim_occ, v_rec, -1), -1),
            spill_victim_begin=to_input(
                torch.where(victim_occ, v_begin, INF_TS), INF_TS),
            spill_victim_end=to_input(
                torch.where(victim_occ, v_end, INF_TS), INF_TS))
    return new_pool, metrics
