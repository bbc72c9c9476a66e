"""Record-partitioned version store, ``n_shards == 1`` subset.

The port of ``repro.store.sharded``. The store keeps the reference's
stacked layout — rings [n, Rl, K], spill pools [n, B, S], ``k_eff``
[n, Rl] with a leading shard axis of size 1 — so state carries across
from a reference engine unchanged (``repro_torch.core.carry``). With one
shard every path short-circuits to the single-ring code, exactly as the
reference's ``n_shards == 1`` fast path does.

Snapshot reads are two-level: the primary ring's gathered windows go
through the ``mvcc_resolve`` kernel, then the record's spill bucket goes
through ``mvcc_resolve_masked``; at most one level holds the visible
version, so combining is a select.

Not ported yet (each raises ``NotImplementedError``): ``n_shards > 1``
logical shards, the ``mesh=`` substrate and the paged primary
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.store.ring import (INF_TS, VersionRing, commit_versions,
                                    gather_windows, gc_ring, i32,
                                    ring_occupancy)
from repro_torch.store.spill import (SpillPool, gc_spill, init_spill_pool,
                                     spill_buckets_for, spill_commit)

_EVICT_KEYS = ("evict_rec", "evict_begin", "evict_end", "evict_payload",
               "evict_valid")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: repro_torch runs one shard with the "
        "dense ring (ROADMAP.md, queue 1)")


@dataclasses.dataclass(frozen=True)
class ShardedVersionStore:
    """Primary rings + spill pool stacked over a leading shard axis."""
    rings: VersionRing            # stacked: begin/end [n, Rl, K]
    spill: Optional[SpillPool]    # stacked [n, B, S, ...] or None
    k_eff: torch.Tensor           # [n, Rl] i32 per-record ring capacity
    num_records: int              # global record count (static)

    @property
    def n_shards(self) -> int:
        return self.rings.begin.shape[0]

    @property
    def records_per_shard(self) -> int:
        return self.rings.begin.shape[1]


def _map(fn, obj):
    """Apply ``fn`` to every tensor field of a frozen dataclass."""
    return type(obj)(*(fn(getattr(obj, f.name))
                       for f in dataclasses.fields(obj)))


def _ring0(store: ShardedVersionStore) -> VersionRing:
    """The squeezed single ring of an n_shards == 1 store."""
    return _map(lambda x: x[0], store.rings)


def _take_spill(store: ShardedVersionStore, s: int) -> Optional[SpillPool]:
    if store.spill is None:
        return None
    return _map(lambda x: x[s], store.spill)


def init_sharded_store(base: torch.Tensor,
                       base_ts: Optional[torch.Tensor] = None,
                       num_slots: int = 4, n_shards: int = 1,
                       spill_buckets: int = 0, spill_slots: int = 0,
                       paged: bool = False) -> ShardedVersionStore:
    """Store whose slot 0 holds the initial open version of every record;
    ``spill_buckets`` x ``spill_slots`` > 0 attaches a spill pool. Every
    record's effective capacity ``k_eff`` starts at ``num_slots``."""
    if int(n_shards) != 1:
        raise _unported("n_shards > 1")
    if paged:
        raise _unported("the paged store")
    R, D = base.shape
    dev = base.device
    if base_ts is None:
        base_ts = torch.zeros((R,), dtype=torch.int32, device=dev)
    begin = torch.full((1, R, num_slots), INF_TS, dtype=torch.int32,
                       device=dev)
    begin[0, :, 0] = base_ts.to(torch.int32)
    end = torch.full((1, R, num_slots), INF_TS, dtype=torch.int32,
                     device=dev)
    payload = torch.zeros((1, R, num_slots, D), dtype=base.dtype,
                          device=dev)
    payload[0, :, 0, :] = base
    head = torch.full((1, R), 1 % num_slots, dtype=torch.int32, device=dev)
    rings = VersionRing(begin=begin, end=end, payload=payload, head=head)
    spill = None
    if int(spill_buckets) > 0 and int(spill_slots) > 0:
        spill = _map(lambda x: x[None],
                     init_spill_pool(spill_buckets, spill_slots, D,
                                     base.dtype, dev))
    return ShardedVersionStore(
        rings=rings, spill=spill,
        k_eff=torch.full((1, R), num_slots, dtype=torch.int32, device=dev),
        num_records=R)


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


def store_occupancy(store: ShardedVersionStore) -> torch.Tensor:
    """[R] live version count per global record."""
    return to_global(store, ring_occupancy(store.rings))


# ---------------------------------------------------------------------------
# Commit: ring maintenance (GC + insert) then the spill tier.
# ---------------------------------------------------------------------------
def _commit_one_shard(ring_s: VersionRing, spill_s: Optional[SpillPool],
                      k_eff_s: torch.Tensor, rec_l, key_l, owned,
                      w_begin_ts, w_end_ts, w_data, watermark, ts_window,
                      pin_ts):
    """One shard's commit: primary ring maintenance, then its live
    evictees into the spill pool at the same clamped watermark."""
    with_spill = spill_s is not None
    ring_o, m = commit_versions(ring_s, rec_l, key_l, owned, w_begin_ts,
                                w_end_ts, w_data, watermark,
                                ts_window=ts_window, k_eff=k_eff_s,
                                pin_ts=pin_ts, with_evictees=with_spill)
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
    """Commit ALL batch versions into the ring (and live evictees into
    the spill pool). ``ring_overwrote_rec`` / ``ring_overwrote_dead_rec``
    keep the per-shard [n, Rl] layout, as in the reference."""
    if mesh is not None:
        raise _unported("the mesh= substrate")
    ring, spill0, metrics = _commit_one_shard(
        _ring0(store), _take_spill(store, 0), store.k_eff[0], w_rec, w_key,
        w_valid, w_begin_ts, w_end_ts, w_data, watermark, ts_window, pin_ts)
    for k in ("ring_overwrote_rec", "ring_overwrote_dead_rec"):
        metrics[k] = metrics[k][None]
    new_spill = None if spill0 is None else _map(lambda x: x[None], spill0)
    return dataclasses.replace(store, rings=_map(lambda x: x[None], ring),
                               spill=new_spill), metrics


def gc_sharded(store: ShardedVersionStore, watermark
               ) -> Tuple[ShardedVersionStore, torch.Tensor]:
    """Standalone watermark GC sweep over the ring and the spill pool."""
    rings, evicted = gc_ring(store.rings, watermark)
    spill = store.spill
    if spill is not None:
        spill, freed = gc_spill(spill, watermark)
        evicted = evicted + freed
    return dataclasses.replace(store, rings=rings, spill=spill), evicted


# ---------------------------------------------------------------------------
# Snapshot reads: gather + mvcc_resolve (primary), then the spill
# fall-through through mvcc_resolve_masked.
# ---------------------------------------------------------------------------
def gather_windows_sharded(store: ShardedVersionStore,
                           records: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(begin [B, K], end [B, K], payload [B, K, D]) primary windows."""
    return gather_windows(_ring0(store), records)


def _resolve_two_level(prim_s: VersionRing, spill_s: Optional[SpillPool],
                       local_rec: torch.Tensor, ts: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary resolve with the spill fall-through: a version leaves the
    primary exactly when it moves to spill and [begin, end) windows
    partition a record's timeline, so at most one level holds the
    version visible at ``ts`` and combining is a select."""
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
    the kernels, primary ring then spill. Returns (vals [B, D], found
    [B])."""
    if mesh is not None:
        raise _unported("the mesh= substrate")
    local = records.to(torch.int32).clamp(min=0).contiguous()
    return _resolve_two_level(_ring0(store), _take_spill(store, 0), local,
                              ts.to(torch.int32).contiguous())
