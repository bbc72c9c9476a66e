"""Silo-style OCC baseline (Tu et al.; port of
``repro.core.baselines.occ``).

Round-based: every pending transaction executes against the current
committed state, then validates in timestamp order — a transaction
commits iff no record in its read-set was written by a smaller-ts
transaction that commits in the same round. Aborted transactions retry
in the next round. The fixpoint inside a round is conservative: commit
iff no smaller-ts pending txn writes any of my read records at all — an
upper bound on the abort rate.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.baselines.two_phase_locking import (min_requester,
                                                         set_rows_last_)
from repro_torch.core.txn import TxnBatch, Workload
from repro_torch.store.ring import i32, isum


def run_occ(base: torch.Tensor, batch: TxnBatch, workload: Workload,
            num_records: int
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    T, Rd = batch.read_set.shape
    R, D = base.shape
    dev = base.device
    ts = torch.arange(T, dtype=torch.int32, device=dev)

    r_rec = batch.read_set.clamp(min=0)
    r_valid = batch.read_set >= 0
    w_rec = batch.write_set.clamp(min=0)
    w_valid = batch.write_set >= 0

    # the committed state with a sentinel row R for masked writes,
    # updated in place round by round (the caller's ``base`` is untouched)
    ext = torch.cat([base, base.new_zeros((1, D))])
    pending = torch.ones((T,), dtype=torch.bool, device=dev)
    reads = torch.zeros((T, Rd, D), dtype=torch.int32, device=dev)
    rounds, aborts = 0, i32(0, dev)
    while bool(pending.any()):                 # one host sync a round
        min_writer = min_requester(ts, pending, w_rec, w_valid, R)
        # also serialize write-write on the same record (first writer
        # wins)
        w_ok = torch.where(w_valid, min_writer[w_rec.long()] >= ts[:, None],
                           True).all(dim=1)
        r_ok = torch.where(r_valid, min_writer[r_rec.long()] >= ts[:, None],
                           True).all(dim=1)
        commit = pending & w_ok & r_ok

        vals = ext[r_rec.long()]
        write_vals, _ = workload.apply(batch.txn_type, vals, batch.args)
        flat = torch.where(w_valid & commit[:, None], w_rec, R).reshape(-1)
        set_rows_last_(ext, flat, write_vals.reshape(-1, D))
        reads = torch.where(commit[:, None, None], vals, reads)
        aborts = aborts + isum(pending & ~commit)
        pending = pending & ~commit
        rounds += 1
    # uniform stats contract: aborted txns retry until they validate, so
    # every txn eventually commits — ``aborts`` counts the validation
    # failures (wasted executions)
    return ext[:R], reads, {"rounds": i32(rounds, dev), "aborts": aborts,
                         "commits": i32(T, dev),
                         "commit_mask": torch.ones((T,), dtype=torch.bool,
                                                   device=dev)}
