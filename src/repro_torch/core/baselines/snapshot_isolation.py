"""Snapshot Isolation baseline (Berenson et al.; port of
``repro.core.baselines.snapshot_isolation``).

Batch-concurrent model: every transaction reads the batch-start snapshot;
write-write conflicts resolve first-committer-wins with commit attempts
in ts order (the earliest-ts writer that actually COMMITS claims the
record; a record whose earlier writer aborted falls to its next-ts
writer). Anti-dependencies are not tracked, so the result can be
NON-serializable (write-skew).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.baselines.two_phase_locking import (min_requester,
                                                         set_rows_last_)
from repro_torch.core.txn import TxnBatch, Workload
from repro_torch.store.ring import i32, isum


def run_si(base: torch.Tensor, batch: TxnBatch, workload: Workload,
           num_records: int
           ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    T, Rd = batch.read_set.shape
    R, D = base.shape
    dev = base.device
    ts = torch.arange(T, dtype=torch.int32, device=dev)

    r_rec = batch.read_set.clamp(min=0)
    w_rec = batch.write_set.clamp(min=0)
    w_valid = batch.write_set >= 0

    # first-COMMITTER-wins per record, commit attempts in ts order: txn t
    # commits iff no committed smaller-ts txn wrote any of its write
    # records — a Kleene fixpoint over the committed set (dependencies
    # are strictly ts-decreasing, so it converges; the iteration count
    # lands in ``rounds``)
    commit = torch.ones((T,), dtype=torch.bool, device=dev)
    prev = torch.zeros((T,), dtype=torch.bool, device=dev)
    rounds = 0
    while bool((commit != prev).any()):        # one host sync a round
        min_c = min_requester(ts, commit, w_rec, w_valid, R)
        prev, commit = commit, torch.where(
            w_valid, min_c[w_rec.long()] >= ts[:, None], True).all(dim=1)
        rounds += 1

    vals = base[r_rec.long()]                               # snapshot reads
    write_vals, _ = workload.apply(batch.txn_type, vals, batch.args)
    flat = torch.where(w_valid & commit[:, None], w_rec, R).reshape(-1)
    final = set_rows_last_(torch.cat([base, base.new_zeros((1, D))]), flat,
                           write_vals.reshape(-1, D))[:R]
    # uniform stats contract: SI aborts are PERMANENT (first-committer-wins
    # losers do not retry in this batch model) — ``commit_mask`` names the
    # survivors
    return final, vals, {"rounds": i32(rounds, dev),
                         "aborts": isum(~commit),
                         "commits": isum(commit),
                         "commit_mask": commit}
