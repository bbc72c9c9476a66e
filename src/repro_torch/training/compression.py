"""Gradient compression for cross-pod traffic reduction: the port of
``repro.training.compression``.

int8 per-tensor-scaled quantization of every gradient with at least
``min_size`` elements, applied before the optimizer so the optimizer
sees what a multi-pod deployment would put on the wire. ``torch.round``
rounds half to even, as ``jnp.round`` does, and the scale is a true
quotient on either device, so the result equals the reference's bit for
bit, on the card as on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"          # int8 | none
    min_size: int = 4096        # don't quantize tiny tensors (norms etc.)


def _q8(g: torch.Tensor) -> torch.Tensor:
    gf = g.float()
    # a divisor on the tensor's device: CUDA divides by a Python number
    # as a product with its rounded reciprocal, one ulp off the quotient
    # for ~5 % of maxima, which changes every element of the leaf
    scale = torch.max(torch.abs(gf)) / torch.full(
        (), 127.0, device=gf.device) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads, cfg: Optional[CompressionConfig]):
    """``grads`` (a nested dict of tensors) with every leaf of at least
    ``cfg.min_size`` elements quantized to int8 and back (float32)."""
    if cfg is None or cfg.kind == "none":
        return grads
    if isinstance(grads, dict):
        return {k: compress_grads(v, cfg) for k, v in grads.items()}
    return _q8(grads) if grads.numel() >= cfg.min_size else grads
