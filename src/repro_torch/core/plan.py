"""Bohm concurrency-control phase (paper §4.1), port of ``repro.core.plan``.

The per-record sequential placeholder insert becomes one sort + segment
pass:

  1. every transaction t in the batch gets ts = ts_base + t;
  2. the write-sets flatten to (record, ts) keys, stably sorted — within
     a record, entries stay in ts order (and, for a transaction that
     names a record twice, in program order);
  3. a version's end_ts is its successor's begin_ts in the record segment
     (else infinity);
  4. reads resolve by a left binary search over the sorted keys: the
     visible version is the latest in-batch write with key strictly below
     the reader's, else the pre-batch head.

Keys are int64 ``rec * T + t`` with pad 0xFFFFFFFF — the same values and
order as the reference's uint32 keys, which torch cannot sort or search
well.

Batch footprints (``BatchFootprint``, ``batch_footprint``,
``footprints_conflict``, ``conflict_witness``, ``merge_footprints``,
``merge_batches``) are the conflict-aware scheduler's host-side record
bitsets (``repro_torch.service.TxnService``); they stay numpy, as in the
reference.

Record-partitioned CC (paper §4.1.2, ``cc_plan_sharded``): every shard
examines every transaction and plans only the records it owns (record
``r`` at shard ``r % n``), with no communication inside the phase. The
logical form loops over the shards on one device and returns the
[n, ...] plan; on a ``cc`` mesh each rank plans its own shard (a plan
of DTensors placed Shard(0)). ``merge_sharded_plan`` gathers a mesh
plan to every rank (one all-gather) and collapses it into the
single-store layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.txn import TxnBatch
from repro_torch.store.ring import INF_TS, i32
from repro_torch.store.sharded import (cc_size, cc_submesh, gather_many,
                                       shard_map)

# composite (record, ts) keys need R * T < 2^32 (R <= 2^20 records,
# checked in the engine) — the one home of the batch/epoch size limit
MAX_BATCH_TXNS = 1 << 12

PAD_KEY = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Plan:
    """Output of the CC phase — everything execution needs, precomputed."""
    # sorted placeholder versions (one per write-set entry, pads at end)
    w_rec: torch.Tensor        # [Nw] record id (INT32_MAX for pads)
    w_txn: torch.Tensor        # [Nw] local producer txn index
    w_end_local: torch.Tensor  # [Nw] local ts of invalidating txn (or T)
    w_valid: torch.Tensor      # [Nw] bool
    w_key: torch.Tensor        # [Nw] int64 sorted (rec * T + t) keys
    # per-transaction annotations
    w_slot: torch.Tensor       # [T, W] slot of txn's writes in sorted array
    r_dep_txn: torch.Tensor    # [T, Rd] producer txn of each read (-1=base)
    r_dep_slot: torch.Tensor   # [T, Rd] version slot of each read (-1=base)
    # commit info: batch-final versions become the new single-version heads
    commit_mask: torch.Tensor  # [Nw] bool: head version after the batch
    ts_base: torch.Tensor      # [] global timestamp of txn 0
    # global version lifetimes — consumed by the persistent version ring
    w_begin_ts: torch.Tensor   # [Nw] global begin ts (INF_TS for pads)
    w_end_ts: torch.Tensor     # [Nw] global end ts (INF_TS = open)


def _keys(rec: torch.Tensor, t: torch.Tensor, T: int) -> torch.Tensor:
    """Composite (record, ts) ordering key, int64."""
    return rec.to(torch.int64) * T + t.to(torch.int64)


def cc_plan(batch, ts_base) -> Plan:
    T, W = batch.write_set.shape
    Rd = batch.read_set.shape[1]
    Nw = T * W
    dev = batch.write_set.device

    flat_rec = batch.write_set.reshape(-1)                       # [Nw]
    flat_t = torch.arange(T, dtype=torch.int32,
                          device=dev).repeat_interleave(W)       # [Nw]
    valid = flat_rec >= 0
    keys = torch.where(valid, _keys(flat_rec.clamp(min=0), flat_t, T),
                       PAD_KEY)

    # stable: a txn whose write-set names the same record twice produces
    # duplicate keys — program order (write column) breaks the tie
    w_key, order = torch.sort(keys, stable=True)
    w_rec = torch.where(valid, flat_rec, INF_TS)[order]
    w_valid = valid[order]
    w_txn = torch.where(w_valid, flat_t[order], -1)

    # end timestamp: successor's begin within the same record segment
    nxt_rec = torch.cat([w_rec[1:], i32([INF_TS], dev)])
    nxt_txn = torch.cat([w_txn[1:], i32([T], dev)])
    same = nxt_rec == w_rec
    w_end_local = torch.where(same, nxt_txn, T)                 # T == "inf"
    commit_mask = w_valid & ~same                               # seg-last

    # inverse permutation: where did txn t's w-th write land?
    inv = torch.empty(Nw, dtype=torch.int32, device=dev)
    inv[order] = torch.arange(Nw, dtype=torch.int32, device=dev)
    w_slot = torch.where(valid.reshape(T, W), inv.reshape(T, W), -1)

    # read resolution: latest in-batch write strictly below the reader's
    # (record, ts) key — an RMW reads its predecessor, not itself
    r_rec = batch.read_set                                      # [T, Rd]
    r_t = torch.arange(T, dtype=torch.int32, device=dev)[:, None].expand(
        T, Rd)
    r_valid = r_rec >= 0
    r_keys = _keys(torch.where(r_valid, r_rec, 0), r_t, T)
    pos = (torch.searchsorted(w_key, r_keys.reshape(-1), side="left")
           - 1).to(torch.int32).reshape(T, Rd)
    safe_pos = pos.clamp(min=0).long()
    cand_rec = torch.where(pos >= 0, w_rec[safe_pos], -1)
    hit = r_valid & (pos >= 0) & (cand_rec == r_rec)
    r_dep_slot = torch.where(hit, pos, -1)
    r_dep_txn = torch.where(hit, w_txn[safe_pos], -1)

    ts_base = i32(ts_base, dev)
    w_begin_ts = torch.where(w_valid, ts_base + w_txn, INF_TS)
    w_end_ts = torch.where(w_valid & (w_end_local < T),
                           ts_base + w_end_local, INF_TS)
    return Plan(w_rec=w_rec, w_txn=w_txn, w_end_local=w_end_local,
                w_valid=w_valid, w_key=w_key, w_slot=w_slot,
                r_dep_txn=r_dep_txn, r_dep_slot=r_dep_slot,
                commit_mask=commit_mask, ts_base=ts_base,
                w_begin_ts=w_begin_ts, w_end_ts=w_end_ts)


# ---------------------------------------------------------------------------
# Record-partitioned CC (paper §4.1.2): each shard receives the full batch
# ("every CC thread examines every transaction") and plans only the records
# it owns. No communication inside the phase.
# ---------------------------------------------------------------------------
def _owned_batch(batch, n: int, shard: int):
    """The batch with every read and write of a record that ``shard``
    does not own masked to -1 (the reference's shard body)."""
    def mask(rec):
        return torch.where(((rec % n) == shard) & (rec >= 0), rec, -1)
    return TxnBatch(mask(batch.read_set), mask(batch.write_set),
                    batch.txn_type, batch.args)


def cc_plan_sharded(batch, ts_base, mesh=None, axis: str = "cc",
                    n_shards: Optional[int] = None) -> Plan:
    """The [n, ...] plan: shard ``s``'s row is ``cc_plan`` of the batch
    masked to the records ``s`` owns. With ``mesh`` (its ``axis`` size is
    n) each rank plans its own shard and the plan's fields are DTensors
    placed Shard(0) over the mesh; without one, ``n_shards`` logical
    shards are planned one after another on the batch's device."""
    if mesh is not None:
        n = cc_size(mesh, axis)
        sub = cc_submesh(mesh, axis)
        return shard_map(
            lambda s, b: (_map_plan(lambda x: x[None],
                                    cc_plan(_owned_batch(b, n, s),
                                            ts_base)), None),
            sub, batch)[0]
    n = int(n_shards)
    parts = [cc_plan(_owned_batch(batch, n, s), ts_base) for s in range(n)]
    return Plan(*(torch.stack([getattr(p, f.name) for p in parts])
                  for f in dataclasses.fields(Plan)))


def _map_plan(fn, plan: Plan) -> Plan:
    return Plan(*(fn(getattr(plan, f.name))
                  for f in dataclasses.fields(Plan)))


def merge_sharded_plan(plan: Plan, batch=None) -> Plan:
    """Collapse an [n, ...] plan into the single-store layout.

    Per-shard slots index per-shard version arrays; execution uses
    (shard, slot) pairs encoded as ``shard * Nw + slot``. Reads and writes
    merge by maximum (each entry is owned by exactly one shard; the
    others hold -1 / pads). ``ts_base`` is element 0 of the shards'
    (equal) bases. A plan of DTensors (a mesh's) is first gathered to
    every rank in one all-gather, so every rank merges the same whole
    plan. ``batch`` is unused (the reference's signature)."""
    fields = [getattr(plan, f.name) for f in dataclasses.fields(Plan)]
    if isinstance(plan.w_rec, DTensor):
        mesh = plan.w_rec.device_mesh
        fields = gather_many([x.to_local()[0] for x in fields], mesh)
    plan = Plan(*fields)
    n, Nw = plan.w_rec.shape[0], plan.w_rec.shape[1]
    off = (torch.arange(n, dtype=torch.int32,
                        device=plan.w_rec.device) * Nw)

    def enc(slot):
        shape = (n,) + (1,) * (slot.dim() - 1)
        return torch.where(slot >= 0, slot + off.reshape(shape), -1)

    return Plan(
        w_rec=plan.w_rec.reshape(-1),
        w_txn=plan.w_txn.reshape(-1),
        w_end_local=plan.w_end_local.reshape(-1),
        w_valid=plan.w_valid.reshape(-1),
        w_key=plan.w_key.reshape(-1),
        w_slot=enc(plan.w_slot).max(0).values,
        r_dep_txn=plan.r_dep_txn.max(0).values,
        r_dep_slot=enc(plan.r_dep_slot).max(0).values,
        commit_mask=plan.commit_mask.reshape(-1),
        ts_base=plan.ts_base.reshape(-1)[0],
        w_begin_ts=plan.w_begin_ts.reshape(-1),
        w_end_ts=plan.w_end_ts.reshape(-1))


# ---------------------------------------------------------------------------
# Batch footprints: per-batch read/write record bitsets for the
# conflict-aware admission scheduler (``repro_torch.service.TxnService``).
#
# Two adjacent batches commute — their merged CC epoch is identical to
# running them back to back — exactly when each batch's write-set is
# disjoint from the other's read UNION write set. The same condition lets
# exec(b+1) run against the pre-commit(b) store (exec reads only
# ``store.base`` rows in b+1's read-set, none of which commit(b) writes).
#
# Footprints live on the HOST (packed numpy uint64 bitsets): admission
# decisions are control flow. Every footprint also carries a one-word
# BLOCK signature (bit j <=> some touched 64-record block w has
# w % 64 == j); disjoint signatures certify disjoint footprints, so the
# window scan tests one word before the [R/64] word scan.
# ---------------------------------------------------------------------------
def _fold_sig(bits: np.ndarray) -> int:
    """uint64 block signature of a packed bitset (see note above)."""
    nz = np.flatnonzero(bits)
    if not nz.size:
        return 0
    return int(np.bitwise_or.reduce(
        np.uint64(1) << (nz.astype(np.uint64) & np.uint64(63))))


@dataclasses.dataclass(frozen=True)
class BatchFootprint:
    """Packed per-batch record bitsets (bit r set <=> record r touched)
    plus their uint64 signatures (computed once at admission)."""
    read_bits: np.ndarray    # [ceil(R/64)] uint64, reads incl. RMW reads
    write_bits: np.ndarray   # [ceil(R/64)] uint64
    write_sig: int = -1      # block signature of write_bits (< 0: compute)
    rw_sig: int = -1         # block signature of read_bits | write_bits

    def __post_init__(self):
        if self.write_sig < 0:
            object.__setattr__(self, "write_sig",
                               _fold_sig(self.write_bits))
        if self.rw_sig < 0:
            object.__setattr__(self, "rw_sig",
                               _fold_sig(self.read_bits | self.write_bits))

    @property
    def rw_bits(self) -> np.ndarray:
        return self.read_bits | self.write_bits


def _pack_bits(records: np.ndarray, num_records: int) -> np.ndarray:
    bits = np.zeros((num_records + 63) // 64, np.uint64)
    rec = records[records >= 0].astype(np.int64).reshape(-1)
    np.bitwise_or.at(bits, rec >> 6, np.uint64(1) << (rec & 63).astype(
        np.uint64))
    return bits


def _host(x) -> np.ndarray:
    """A host numpy view of a batch array: the tensor's own memory on the
    CPU, one device-to-host copy for a batch built on the card."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batch_footprint(batch: TxnBatch, num_records: int) -> BatchFootprint:
    """One pass over the batch's read/write sets at admission time."""
    return BatchFootprint(
        read_bits=_pack_bits(_host(batch.read_set), num_records),
        write_bits=_pack_bits(_host(batch.write_set), num_records))


def signatures_disjoint(a: BatchFootprint, b: BatchFootprint) -> bool:
    """One-word certificate: True guarantees ``not footprints_conflict``.
    False means "may conflict" — the caller falls back to the word scan."""
    return not ((a.write_sig & b.rw_sig) | (b.write_sig & a.rw_sig))


def footprints_conflict(a: BatchFootprint, b: BatchFootprint) -> bool:
    """True when the batches do NOT commute: some write of one intersects
    the other's read-or-write set (in either direction). The signature
    check runs first; only colliding signatures pay for the word scan."""
    if signatures_disjoint(a, b):
        return False
    return bool(np.any(a.write_bits & b.rw_bits)
                or np.any(b.write_bits & a.rw_bits))


def conflict_witness(a: BatchFootprint, b: BatchFootprint
                     ) -> Optional[int]:
    """A concrete record id proving ``footprints_conflict(a, b)``: the
    lowest record written by one batch and touched by the other (a's
    writes first). None when the footprints commute. The flight
    recorder's conflict-attribution primitive."""
    for cross in (a.write_bits & b.rw_bits, b.write_bits & a.rw_bits):
        nz = np.flatnonzero(cross)
        if nz.size:
            w = int(nz[0])
            bit = int(cross[w])
            return w * 64 + ((bit & -bit).bit_length() - 1)
    return None


def merge_footprints(a: BatchFootprint, b: BatchFootprint) -> BatchFootprint:
    # a block is touched in a|b iff it is touched in a or in b, so the
    # merged signatures are the OR of the members' signatures
    return BatchFootprint(read_bits=a.read_bits | b.read_bits,
                          write_bits=a.write_bits | b.write_bits,
                          write_sig=a.write_sig | b.write_sig,
                          rw_sig=a.rw_sig | b.rw_sig)


def merge_batches(a: TxnBatch, b: TxnBatch) -> TxnBatch:
    """Concatenate two batches into one CC epoch, preserving submission
    order (txn t of ``b`` becomes txn ``a.size + t``, so every global
    timestamp equals running the batches back to back). Callers check
    ``not footprints_conflict(...)``; widths must agree. The result lies
    on the batches' device."""
    if (a.n_read, a.n_write, tuple(a.args.shape[1:])) != \
            (b.n_read, b.n_write, tuple(b.args.shape[1:])):
        raise ValueError("merge_batches requires identical batch widths")
    return TxnBatch(*(torch.cat([getattr(a, f.name), getattr(b, f.name)])
                      for f in dataclasses.fields(a)))
