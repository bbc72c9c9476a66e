"""Device resolution for the port's entry points.

Every entry point (``BohmEngine``, ``build``, the batch generators) takes
``device=None`` and runs on the card unless the caller names the CPU.
There is no silent fallback: asking for the card on a machine without
one raises, so a run that was meant to measure the GPU can never finish
on the CPU by accident. ``fence`` is the one host join of the
scheduler (``repro_torch.service``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a visible GPU
    raises ``RuntimeError``. ``"cpu"`` must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "visible; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def fence(x):
    """Wait until the work that produces ``x`` (a tensor) has finished, and
    return ``x``: the current stream's ``synchronize()`` when ``x`` lies on
    a CUDA device, nothing on the CPU, where tensor work is synchronous.
    The one host join of the port's scheduler (``TxnService``): every join
    goes through this attribute, so a test can count them."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return x
