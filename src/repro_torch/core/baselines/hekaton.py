"""Hekaton-style pessimistic MVCC baseline (Larson et al., as the paper
characterises it in §2.2/§3; port of ``repro.core.baselines.hekaton``).

Hekaton-pessimistic tracks reads: every read increments a counter on the
record (a write to shared memory on reads — the cost Bohm avoids), and a
writer cannot commit until every concurrent reader of its write-set has
finished.

Round-based batch model:
  - readers never block: every pending transaction reads immediately;
  - a transaction commits in round r iff (a) no older pending transaction
    writes any record it accesses and (b) no older pending transaction
    READS any record it writes (the "wait for readers to drain" rule);
  - ``max_read_crowd`` is the largest number of transactions bumping one
    record's read counter — the cache-line-bouncing proxy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.baselines.two_phase_locking import (min_requester,
                                                         set_rows_last_)
from repro_torch.core.txn import TxnBatch, Workload
from repro_torch.store.ring import i32, isum


def run_hekaton(base: torch.Tensor, batch: TxnBatch, workload: Workload,
                num_records: int
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
    T, Rd = batch.read_set.shape
    R, D = base.shape
    dev = base.device
    ts = torch.arange(T, dtype=torch.int32, device=dev)

    r_rec = batch.read_set.clamp(min=0)
    r_valid = batch.read_set >= 0
    w_rec = batch.write_set.clamp(min=0)
    w_valid = batch.write_set >= 0

    # read-counter contention proxy over the whole batch (the reference's
    # ``.at[].add`` as an ``index_add_`` on a sentinel row R)
    flat_reads = torch.where(r_valid, r_rec, R).reshape(-1).long()
    crowd = torch.zeros((R + 1,), dtype=torch.int32, device=dev).index_add_(
        0, flat_reads, r_valid.reshape(-1).to(torch.int32))
    max_read_crowd = crowd[:R].max()

    # the committed state with a sentinel row R for masked writes,
    # updated in place round by round (the caller's ``base`` is untouched)
    ext = torch.cat([base, base.new_zeros((1, D))])
    pending = torch.ones((T,), dtype=torch.bool, device=dev)
    reads = torch.zeros((T, Rd, D), dtype=torch.int32, device=dev)
    rounds, bumps = 0, i32(0, dev)
    while bool(pending.any()):                 # one host sync a round
        min_w = min_requester(ts, pending, w_rec, w_valid, R)
        min_r = min_requester(ts, pending, r_rec, r_valid, R)
        # ww/wr ordering + the Hekaton rule: an older pending READER of a
        # written record blocks the writer's commit
        w_ok = torch.where(
            w_valid,
            (min_w[w_rec.long()] >= ts[:, None])
            & (min_r[w_rec.long()] >= ts[:, None]), True).all(dim=1)
        r_ok = torch.where(r_valid, min_w[r_rec.long()] >= ts[:, None],
                           True).all(dim=1)
        commit = pending & w_ok & r_ok

        vals = ext[r_rec.long()]
        write_vals, _ = workload.apply(batch.txn_type, vals, batch.args)
        flat = torch.where(w_valid & commit[:, None], w_rec, R).reshape(-1)
        set_rows_last_(ext, flat, write_vals.reshape(-1, D))
        reads = torch.where(commit[:, None, None], vals, reads)
        # read-counter bumps this round: every pending txn's valid reads
        # (acquire) + every committing txn's (release)
        bumps = bumps + isum(pending[:, None] & r_valid) \
            + isum(commit[:, None] & r_valid)
        pending = pending & ~commit
        rounds += 1
    # uniform stats contract: pessimistic MVCC never aborts on conflict —
    # writers WAIT for readers instead (the rounds count)
    return ext[:R], reads, {"rounds": i32(rounds, dev),
                         "read_counter_bumps": bumps,
                         "max_read_crowd": max_read_crowd,
                         "aborts": i32(0, dev), "commits": i32(T, dev),
                         "commit_mask": torch.ones((T,), dtype=torch.bool,
                                                   device=dev)}
