"""Single-version two-phase locking — the paper's primary comparison
system (port of ``repro.core.baselines.two_phase_locking``).

Deterministic round-based simulation of a 2PL executor pool:

  - every pending transaction requests shared locks on its read-set and
    exclusive locks on its write-set;
  - a transaction acquires its locks iff, for every requested record, no
    *older* pending transaction requests that record in a conflicting mode
    (timestamp-ordered acquisition == wound-wait: deadlock-free, and the
    oldest transaction always progresses, so every batch terminates);
  - all transactions that acquired locks execute in one round (they are
    pairwise non-conflicting, so parallel execution is serializable);
    everything else waits for the next round.

``rounds`` is the lock-conflict critical path. Latch and cache-line
effects (paper §5.3.2) are not modelled.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.txn import TxnBatch, Workload
from repro_torch.store.ring import i32, isum


def min_requester(ts: torch.Tensor, pending: torch.Tensor,
                  rec: torch.Tensor, valid: torch.Tensor,
                  R: int) -> torch.Tensor:
    """[R + 1] smallest pending ts requesting each record in one mode
    (``T`` where none does; row R absorbs the pads) — the reference's
    ``.at[].min`` as an ``amin`` scatter."""
    T = ts.shape[0]
    t_b = torch.where(valid & pending[:, None], ts[:, None], T)
    flat = torch.where(valid, rec, R).reshape(-1).long()
    out = torch.full((R + 1,), T, dtype=torch.int32, device=ts.device)
    return out.scatter_reduce_(0, flat, t_b.reshape(-1).to(torch.int32),
                               "amin")


def set_rows_last_(ext: torch.Tensor, idx: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """In place ``ext[idx] = src`` along dim 0 for indices that may
    repeat (a transaction may name a record twice): a row named by
    several entries takes the LAST one's value (update order), as the
    reference's serial XLA scatter does, on the card as on the CPU. The
    last row of ``ext`` is the sentinel that takes masked entries and the
    earlier duplicates — the reference's ``mode="drop"`` row. Returns
    ``ext``."""
    idx = idx.long()
    s_idx, order = torch.sort(idx, stable=True)
    seg_last = torch.ones_like(s_idx, dtype=torch.bool)
    seg_last[:-1] = s_idx[1:] != s_idx[:-1]
    keep = torch.empty_like(seg_last)
    keep[order] = seg_last
    ext[torch.where(keep, idx, ext.shape[0] - 1)] = src
    return ext


def run_2pl(base: torch.Tensor, batch: TxnBatch, workload: Workload,
            num_records: int
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (final_base, read_vals, metrics)."""
    T, Rd = batch.read_set.shape
    R, D = base.shape
    dev = base.device

    r_rec = batch.read_set.clamp(min=0)
    r_valid = batch.read_set >= 0
    w_rec = batch.write_set.clamp(min=0)
    w_valid = batch.write_set >= 0
    ts = torch.arange(T, dtype=torch.int32, device=dev)

    # the committed state with a sentinel row R for masked writes,
    # updated in place round by round (the caller's ``base`` is untouched)
    ext = torch.cat([base, base.new_zeros((1, D))])
    pending = torch.ones((T,), dtype=torch.bool, device=dev)
    reads = torch.zeros((T, Rd, D), dtype=torch.int32, device=dev)
    rounds, waits = 0, i32(0, dev)
    while bool(pending.any()):                 # one host sync a round
        min_w = min_requester(ts, pending, w_rec, w_valid, R)
        min_r = min_requester(ts, pending, r_rec, r_valid, R)
        # txn t gets its exclusive locks iff it is the min (w or r)
        # requester on each written record; shared locks iff no older
        # writer requests
        w_ok = torch.where(
            w_valid,
            (min_w[w_rec.long()] >= ts[:, None])
            & (min_r[w_rec.long()] >= ts[:, None]), True).all(dim=1)
        r_ok = torch.where(r_valid, min_w[r_rec.long()] >= ts[:, None],
                           True).all(dim=1)
        grant = pending & w_ok & r_ok

        vals = ext[r_rec.long()]                          # [T, Rd, D]
        write_vals, _ = workload.apply(batch.txn_type, vals, batch.args)
        flat = torch.where(w_valid & grant[:, None], w_rec, R).reshape(-1)
        set_rows_last_(ext, flat, write_vals.reshape(-1, D))
        reads = torch.where(grant[:, None, None], vals, reads)
        # lock waits: every pending txn denied its locks this round
        waits = waits + isum(pending & ~grant)
        pending = pending & ~grant
        rounds += 1
    # uniform stats contract: 0-d int32 scalars + a [T] commit mask — 2PL
    # never aborts (wound-wait on ts order terminates)
    return ext[:R], reads, {"rounds": i32(rounds, dev), "lock_waits": waits,
                         "aborts": i32(0, dev), "commits": i32(T, dev),
                         "commit_mask": torch.ones((T,), dtype=torch.bool,
                                                   device=dev)}
