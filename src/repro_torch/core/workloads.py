"""Paper workloads: microbenchmark (§5.1), YCSB (§5.2), SmallBank (§5.3).

Record payloads are D int32 words; word 0 carries the integer value the
transaction logic manipulates, the rest rides along to model the copy
cost of writing full versions. The numpy generators are a line-for-line
copy of ``repro.core.workloads`` (one seed, equal arrays); the branches
are the batched form of the reference's per-transaction branches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.txn import TxnBatch, Workload, make_batch
from repro_torch.device import DeviceLike


# ---------------------------------------------------------------------------
# Branch helpers (batched: vals [T, Rd, D], args [T, A])
# ---------------------------------------------------------------------------
def _no_abort(vals: torch.Tensor) -> torch.Tensor:
    return torch.zeros(vals.shape[0], dtype=torch.bool, device=vals.device)


def _bump_payload(vals: torch.Tensor, inc) -> torch.Tensor:
    """RMW: word0 += inc (per txn), remaining words copied."""
    out = vals.clone()
    out[..., 0] += inc
    return out


# --- YCSB: type 0 = 10RMW, type 1 = 2RMW-8R --------------------------------
def make_ycsb(payload_words: int = 2, ops: int = 10) -> Workload:
    def rmw_all(read_vals, args):
        # writes mirror the read set order (10 RMWs)
        return _bump_payload(read_vals, 1), _no_abort(read_vals)

    def rmw2_read8(read_vals, args):
        # first 2 records RMW'd; writes array is [ops] wide, padded
        return _bump_payload(read_vals, 1), _no_abort(read_vals)

    return Workload(name="ycsb", n_read=ops, n_write=ops,
                    payload_words=payload_words,
                    branches=(rmw_all, rmw2_read8))


def gen_ycsb_batch(rng: np.random.Generator, n_txns: int, n_records: int,
                   theta: float = 0.0, mix: str = "10rmw",
                   ops: int = 10, device: DeviceLike = None) -> TxnBatch:
    recs = _sample_distinct(rng, n_txns, ops, n_records, theta)
    read_set = recs
    if mix == "10rmw":
        write_set = recs.copy()
        types = np.zeros(n_txns, np.int32)
    elif mix == "2rmw8r":
        write_set = np.full_like(recs, -1)
        write_set[:, :2] = recs[:, :2]
        types = np.ones(n_txns, np.int32)
    else:
        raise ValueError(mix)
    args = np.zeros((n_txns, 1), np.int32)
    return make_batch(read_set, write_set, types, args, device=device)


# --- Microbenchmark (§5.1): same as YCSB 10RMW, 8-byte records -------------
def make_microbench() -> Workload:
    return make_ycsb(payload_words=2, ops=10)


# --- Read-only snapshot scans (Figs 9/10 scenario) --------------------------
# A scan transaction reads ``ops`` records and writes nothing; it is meant
# for ``BohmEngine.run_readonly_batch``, which resolves every read against
# the version ring at a pinned snapshot timestamp.
def make_scan(ops: int = 10, payload_words: int = 2) -> Workload:
    def scan(read_vals, args):
        return read_vals, _no_abort(read_vals)

    return Workload(name="scan", n_read=ops, n_write=ops,
                    payload_words=payload_words, branches=(scan,))


def gen_scan_batch(rng: np.random.Generator, n_txns: int, n_records: int,
                   ops: int = 10, theta: float = 0.0,
                   device: DeviceLike = None) -> TxnBatch:
    recs = _sample_distinct(rng, n_txns, ops, n_records, theta)
    write_set = np.full_like(recs, -1)
    types = np.zeros(n_txns, np.int32)
    args = np.zeros((n_txns, 1), np.int32)
    return make_batch(recs, write_set, types, args, device=device)


# --- SmallBank (§5.3) -------------------------------------------------------
# Records: savings account of customer c -> record 2c; checking -> 2c + 1.
# read_set / write_set width 3. Types:
#   0 Balance        reads  (sav, chk)           writes ()
#   1 Deposit        reads  (chk,)               writes (chk,)     chk += a
#   2 TransactSaving reads  (sav,)               writes (sav,)     sav += a,
#                                                abort if result < 0
#   3 Amalgamate     reads  (savA, chkA, chkB)   writes all three
#   4 WriteCheck     reads  (sav, chk)           writes (chk,)     chk -= a
#                                                (+1 penalty if overdraft)
SB_OPS = 3


def make_smallbank(payload_words: int = 2) -> Workload:
    def balance(vals, args):
        return vals, _no_abort(vals)

    def deposit(vals, args):
        return _bump_payload(vals, args[:, 0, None]), _no_abort(vals)

    def transact_saving(vals, args):
        a = args[:, 0]
        abort = vals[:, 0, 0] + a < 0
        out = vals.clone()
        out[..., 0] = torch.where(abort[:, None], vals[..., 0],
                                  vals[..., 0] + a[:, None])
        return out, abort

    def amalgamate(vals, args):
        total = vals[:, 0, 0] + vals[:, 1, 0]
        out = vals.clone()
        out[:, 0, 0] = 0
        out[:, 1, 0] = 0
        out[:, 2, 0] += total
        return out, _no_abort(vals)

    def write_check(vals, args):
        a = args[:, 0]
        total = vals[:, 0, 0] + vals[:, 1, 0]
        penalty = (a > total).to(vals.dtype)
        out = vals.clone()
        out[:, 1, 0] -= a + penalty
        return out, _no_abort(vals)

    return Workload(name="smallbank", n_read=SB_OPS, n_write=SB_OPS,
                    payload_words=payload_words,
                    branches=(balance, deposit, transact_saving, amalgamate,
                              write_check), may_abort=True)


def gen_smallbank_batch(rng: np.random.Generator, n_txns: int,
                        n_customers: int,
                        mix: Tuple[float, ...] = (0.2,) * 5,
                        device: DeviceLike = None) -> TxnBatch:
    types = rng.choice(5, size=n_txns, p=np.asarray(mix) / sum(mix)
                       ).astype(np.int32)
    c1 = rng.integers(0, n_customers, n_txns)
    c2 = (c1 + 1 + rng.integers(0, max(n_customers - 1, 1), n_txns)) \
        % max(n_customers, 1)
    sav1, chk1, chk2 = 2 * c1, 2 * c1 + 1, 2 * c2 + 1
    reads = np.full((n_txns, SB_OPS), -1, np.int64)
    writes = np.full((n_txns, SB_OPS), -1, np.int64)
    amounts = rng.integers(1, 100, n_txns)

    m = types == 0   # Balance
    reads[m, 0], reads[m, 1] = sav1[m], chk1[m]
    m = types == 1   # Deposit
    reads[m, 0] = chk1[m]
    writes[m, 0] = chk1[m]
    m = types == 2   # TransactSaving (can go negative -> may abort)
    reads[m, 0] = sav1[m]
    writes[m, 0] = sav1[m]
    amounts[m] = rng.integers(-150, 100, int(m.sum()))
    m = types == 3   # Amalgamate
    reads[m, 0], reads[m, 1], reads[m, 2] = sav1[m], chk1[m], chk2[m]
    writes[m, 0], writes[m, 1], writes[m, 2] = sav1[m], chk1[m], chk2[m]
    m = types == 4   # WriteCheck — write row aligns with read row 1 (chk)
    reads[m, 0], reads[m, 1] = sav1[m], chk1[m]
    writes[m, 1] = chk1[m]

    args = amounts.astype(np.int32)[:, None]
    return make_batch(reads, writes, types, args, device=device)


# ---------------------------------------------------------------------------
# Zipfian sampling (Gray et al. [16], as parameterised in the paper):
# theta in [0, 1); 0 = uniform, larger = more contended.
# ---------------------------------------------------------------------------
def zipf_probs(n: int, theta: float) -> np.ndarray:
    if theta <= 0.0:
        return np.full(n, 1.0 / n)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks, theta)
    return w / w.sum()


_ZIPF_CACHE = {}


def _sample_distinct(rng, n_txns, ops, n_records, theta) -> np.ndarray:
    """ops distinct records per txn (paper: '10 unique records')."""
    if theta <= 0.0:
        out = rng.integers(0, n_records, size=(n_txns, ops))
    else:
        key = (n_records, round(theta, 6))
        if key not in _ZIPF_CACHE:
            _ZIPF_CACHE[key] = zipf_probs(n_records, theta)
        p = _ZIPF_CACHE[key]
        out = rng.choice(n_records, size=(n_txns, ops), p=p)
    # deduplicate within each txn by linear probing
    for col in range(1, ops):
        for _ in range(4):
            dup = (out[:, col:col + 1] == out[:, :col]).any(axis=1)
            if not dup.any():
                break
            out[dup, col] = (out[dup, col] + 1 + rng.integers(
                0, 97, int(dup.sum()))) % n_records
    return out.astype(np.int64)
