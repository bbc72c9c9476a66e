"""repro_torch — the PyTorch/CUDA port of ``repro`` (Bohm MVCC).

The package mirrors ``repro``'s layout (``repro_torch.core.plan`` is the
port of ``repro.core.plan``) and is held byte-for-byte against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy
only. Entry points run on the GPU unless the caller passes
``device="cpu"``; the snapshot-read path goes through the hand-written
CUDA kernels in ``repro_torch.kernels`` (plain PyTorch versions serve
CPU tensors only).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
