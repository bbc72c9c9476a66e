"""Public wrappers around the port's kernels.

The counterpart of ``repro.kernels.ops``: where the reference selects
Pallas interpret mode by backend, these wrappers select by the tensors'
device — a CUDA tensor launches the hand-written kernel (or raises), a
CPU tensor takes the plain PyTorch version.
"""
from repro_torch.kernels.mvcc_resolve import (LAUNCHES, mvcc_resolve,
                                              mvcc_resolve_masked,
                                              mvcc_resolve_masked_plain,
                                              mvcc_resolve_paged,
                                              mvcc_resolve_paged_plain,
                                              mvcc_resolve_plain,
                                              reset_launches)

__all__ = ["LAUNCHES", "mvcc_resolve", "mvcc_resolve_masked",
           "mvcc_resolve_masked_plain", "mvcc_resolve_paged",
           "mvcc_resolve_paged_plain", "mvcc_resolve_plain",
           "reset_launches"]
