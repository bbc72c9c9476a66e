"""Public wrappers around the port's kernels.

The counterpart of ``repro.kernels.ops``: where the reference selects
Pallas interpret mode by backend, these wrappers select by the tensors'
device — a CUDA tensor launches the hand-written kernel (or raises), a
CPU tensor takes the plain PyTorch version. ``LAUNCHES`` counts each
kernel's launches since ``reset_launches()``.
"""
from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention_causal, flash_attention_causal_bwd,
    flash_attention_causal_bwd_plain, flash_attention_causal_plain)
from repro_torch.kernels.mvcc_resolve import (mvcc_resolve,
                                              mvcc_resolve_masked,
                                              mvcc_resolve_masked_plain,
                                              mvcc_resolve_paged,
                                              mvcc_resolve_paged_plain,
                                              mvcc_resolve_plain)

__all__ = ["LAUNCHES", "decode_attention", "decode_attention_plain",
           "flash_attention_causal", "flash_attention_causal_bwd",
           "flash_attention_causal_bwd_plain",
           "flash_attention_causal_plain",
           "mvcc_resolve", "mvcc_resolve_masked",
           "mvcc_resolve_masked_plain", "mvcc_resolve_paged",
           "mvcc_resolve_paged_plain", "mvcc_resolve_plain",
           "reset_launches"]
