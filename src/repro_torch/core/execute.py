"""Bohm execution phase (paper §4.2), port of ``repro.core.execute``.

A deterministic wavefront: each wave executes every transaction whose
read dependencies are all complete, gathers its read values from the
batch's version buffer or the base store, runs the workload logic and
scatters the produced values into the transaction's OWN placeholder
slots. The number of waves equals the longest read-dependency chain.

The reference's ``lax.while_loop`` is a Python loop here: its exit test
``done.all()`` syncs the host once per wave (a device-side loop is later
work, ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.plan import Plan
from repro_torch.core.txn import TxnBatch, Workload
from repro_torch.store import (ShardedVersionStore, commit_sharded,
                               init_sharded_store)
from repro_torch.store.ring import i32, isum, scatter_set


@dataclasses.dataclass(frozen=True)
class Store:
    """Committed state: single-version heads + the persistent version
    store (``base`` caches each record's head version; ``versions`` holds
    the cross-batch rings or page slab and the spill tier)."""
    base: torch.Tensor         # [R, D] head-version payloads
    base_ts: torch.Tensor      # [R] begin ts of the head version
    ts_counter: torch.Tensor   # [] next timestamp to assign
    versions: ShardedVersionStore


def init_store(num_records: int, payload_words: int, init_value: int = 0,
               ring_slots: int = 4, n_shards: int = 1, spill_buckets: int = 0,
               spill_slots: int = 0, k_init: Optional[int] = None,
               paged: bool = False, page_slots: int = 4,
               pages_per_shard: Optional[int] = None, device=None) -> Store:
    base = torch.full((num_records, payload_words), init_value,
                      dtype=torch.int32, device=device)
    return store_from_base(base, None, ring_slots, n_shards, spill_buckets,
                           spill_slots, k_init=k_init, paged=paged,
                           page_slots=page_slots,
                           pages_per_shard=pages_per_shard)


def store_from_base(base: torch.Tensor,
                    base_ts: Optional[torch.Tensor] = None,
                    ring_slots: int = 4, n_shards: int = 1,
                    spill_buckets: int = 0, spill_slots: int = 0,
                    k_init: Optional[int] = None, paged: bool = False,
                    page_slots: int = 4,
                    pages_per_shard: Optional[int] = None) -> Store:
    """Store whose initial state (head + ring slot 0, or each record's
    initial page) is ``base``; the version-store options are those of
    ``init_sharded_store``."""
    base = base.to(torch.int32)
    dev = base.device
    base_ts = (torch.zeros((base.shape[0],), dtype=torch.int32, device=dev)
               if base_ts is None else base_ts.to(device=dev,
                                                  dtype=torch.int32))
    return Store(base=base, base_ts=base_ts, ts_counter=i32(1, dev),
                 versions=init_sharded_store(
                     base, base_ts, ring_slots, n_shards,
                     spill_buckets=spill_buckets,
                     spill_slots=spill_slots, k_init=k_init, paged=paged,
                     page_slots=page_slots,
                     pages_per_shard=pages_per_shard))


def execute_plan(plan: Plan, batch: TxnBatch, store: Store,
                 workload: Workload
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Dict[str, torch.Tensor]]:
    """Run the wavefront. Returns (w_data [Nw, D], read_vals [T, Rd, D],
    metrics)."""
    T, Rd = batch.read_set.shape
    Nw = plan.w_rec.shape[0]
    D = store.base.shape[1]
    dev = store.base.device

    base_reads = store.base[batch.read_set.clamp(min=0).long()]  # [T,Rd,D]
    read_valid = (batch.read_set >= 0)[..., None]
    dep_txn = plan.r_dep_txn.clamp(min=0).long()
    has_dep = plan.r_dep_txn >= 0
    dep_slot = plan.r_dep_slot.clamp(min=0).long()
    in_batch = (plan.r_dep_slot >= 0)[..., None]
    w_slot_ok = plan.w_slot >= 0

    done = torch.zeros((T,), dtype=torch.bool, device=dev)
    w_data = torch.zeros((Nw, D), dtype=torch.int32, device=dev)
    read_out = torch.zeros((T, Rd, D), dtype=torch.int32, device=dev)
    aborted = torch.zeros((T,), dtype=torch.bool, device=dev)
    waves = 0
    while not bool(done.all()):                     # one host sync a wave
        dep_done = torch.where(has_dep, done[dep_txn], True)
        ready = ~done & dep_done.all(dim=1)

        # gather read values: in-batch version slot or base head
        vals = torch.where(in_batch, w_data[dep_slot], base_reads)
        vals = torch.where(read_valid, vals, 0)

        write_vals, abort = workload.apply(batch.txn_type, vals, batch.args)

        # scatter produced values into this txn's placeholder slots
        take = ready[:, None] & w_slot_ok
        flat_slot = torch.where(take, plan.w_slot, Nw).reshape(-1)
        w_data = scatter_set(w_data, flat_slot,
                             torch.where(take[..., None], write_vals,
                                         0).reshape(-1, D))

        read_out = torch.where(ready[:, None, None], vals, read_out)
        # abort flags fold in at each txn's ready wave
        aborted = torch.where(ready, abort, aborted)
        done = done | ready
        waves += 1
        if waves > T:       # every wave completes >= 1 txn of an acyclic plan
            raise RuntimeError("wavefront made no progress: the plan's read "
                               "dependencies are not acyclic")

    metrics = {"waves": i32(waves, dev), "aborts": isum(aborted)}
    return w_data, read_out, metrics


def commit(plan: Plan, batch: TxnBatch, store: Store, w_data: torch.Tensor,
           watermark=None, ts_window: Optional[Tuple] = None,
           pin_ts: Optional[torch.Tensor] = None,
           with_audit: bool = False
           ) -> Tuple[Store, Dict[str, torch.Tensor]]:
    """Batch barrier: fold each record's batch-final version into the head
    cache AND commit every batch version into the persistent rings (see
    ``repro.core.execute.commit`` for ``watermark`` / ``ts_window`` /
    ``pin_ts``; ``with_audit`` adds the lifecycle audit arrays)."""
    if watermark is None:
        watermark = store.ts_counter
    if ts_window is None:
        ts_window = (plan.ts_base, plan.ts_base + batch.read_set.shape[0])
    R = store.base.shape[0]
    rec = torch.where(plan.commit_mask, plan.w_rec, R)          # drop pads
    base = scatter_set(store.base, rec, w_data)
    ts = plan.ts_base + plan.w_txn
    base_ts = scatter_set(store.base_ts, rec,
                          torch.where(plan.commit_mask, ts, 0))
    versions, ring_metrics = commit_sharded(
        store.versions, plan.w_rec, plan.w_key, plan.w_valid,
        plan.w_begin_ts, plan.w_end_ts, w_data, watermark,
        ts_window=ts_window, pin_ts=pin_ts, with_audit=with_audit)
    return Store(base=base, base_ts=base_ts,
                 ts_counter=i32(ts_window[1], store.base.device),
                 versions=versions), ring_metrics
