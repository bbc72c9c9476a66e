"""Transaction-batch representation and workload logic registry.

A batch of T transactions is a frozen dataclass of int32 tensors (pad
with record id -1):

    read_set  [T, R_max] int32   records read (RMW records appear here too)
    write_set [T, W_max] int32   records written (placeholder versions)
    txn_type  [T]        int32   index into the workload's logic branches
    args      [T, A]     int32   per-transaction arguments (amounts, ...)

Workload logic is a list of batched branch functions, one per
transaction type:

    branch(read_vals [T, R_max, D], args [T, A]) -> (write_vals
                                                     [T, W_max, D],
                                                     abort [T] bool)

``Workload.apply`` evaluates every branch on the whole batch and selects
each transaction's result by ``txn_type`` (the batched form of the
reference's ``vmap`` + ``lax.switch``, whose index is clamped to the
branch range the same way). Branches derive write values only from read
values and args, so Bohm's abort rule (copy-forward the predecessor's
value) is the branch returning the read value unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TxnBatch:
    read_set: torch.Tensor      # [T, Rd]
    write_set: torch.Tensor     # [T, W]
    txn_type: torch.Tensor      # [T]
    args: torch.Tensor          # [T, A]

    @property
    def size(self) -> int:
        return self.read_set.shape[0]

    @property
    def n_read(self) -> int:
        return self.read_set.shape[1]

    @property
    def n_write(self) -> int:
        return self.write_set.shape[1]

    def to(self, device) -> "TxnBatch":
        return TxnBatch(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))

    def slice(self, n: int) -> "TxnBatch":
        """The first ``n`` transactions."""
        return TxnBatch(*(getattr(self, f.name)[:n]
                          for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    n_read: int
    n_write: int
    payload_words: int
    branches: Sequence[Callable]     # type index -> batched branch fn
    may_abort: bool = False

    def apply(self, txn_type: torch.Tensor, read_vals: torch.Tensor,
              args: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched over T: read_vals [T, Rd, D] -> ([T, W, D], [T])."""
        idx = txn_type.clamp(0, len(self.branches) - 1)
        out, abort = self.branches[0](read_vals, args)
        for i, branch in enumerate(self.branches[1:], start=1):
            w_i, a_i = branch(read_vals, args)
            take = idx == i
            out = torch.where(take[:, None, None], w_i, out)
            abort = torch.where(take, a_i, abort)
        return out, abort


def make_batch(read_set, write_set, txn_type, args,
               device: DeviceLike = None) -> TxnBatch:
    dev = resolve_device(device)

    def as_i32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.int32)

    return TxnBatch(as_i32(read_set), as_i32(write_set), as_i32(txn_type),
                    as_i32(args))
