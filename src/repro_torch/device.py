"""Device resolution for the port's entry points.

Every entry point (``BohmEngine``, ``build``, the batch generators) takes
``device=None`` and runs on the card unless the caller names the CPU.
There is no silent fallback: asking for the card on a machine without
one raises, so a run that was meant to measure the GPU can never finish
on the CPU by accident. ``fence`` is the one host join of the
scheduler (``repro_torch.service``) and of an enabled tracer's spans
(``repro_torch.obs.trace``).
"""
from __future__ import annotations

import dataclasses
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


def _cuda_leaf(x) -> Optional[torch.Tensor]:
    """The first CUDA tensor in ``x``: a tensor, or a dataclass / tuple /
    list / dict holding tensors (searched depth-first); else None."""
    if isinstance(x, torch.Tensor):
        return x if x.is_cuda else None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            leaf = _cuda_leaf(item)
            if leaf is not None:
                return leaf
    return None


def fence(x):
    """Wait until the work that produces ``x`` has finished, and return
    ``x``: the current stream's ``synchronize()`` when ``x`` (a tensor, or
    a dataclass / tuple / list / dict holding tensors) lies on a CUDA
    device, nothing on the CPU, where tensor work is synchronous. One
    stream wait covers every tensor of ``x``, all enqueued on that
    stream. The one host join of the port's scheduler (``TxnService``)
    and of an enabled tracer's spans: every join goes through this
    attribute, so a test can count them."""
    leaf = _cuda_leaf(x)
    if leaf is not None:
        torch.cuda.current_stream(leaf.device).synchronize()
    return x
