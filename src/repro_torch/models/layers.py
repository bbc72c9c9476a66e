"""Core model layers as pure functions over parameter dicts: the subset
of ``repro.models.layers`` that serving needs.

Parameters are nested dicts of tensors with the reference's
layer-stacked layout (every leaf of ``params["layers"]`` has a leading
``L`` axis). Attention itself is not here: on the serving path it goes
to the kernels (``repro_torch.kernels.ops``); the blockwise
``flash_attention`` / ``attention_decode`` of the reference arrive with
the models/training slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones
    scale_axis: int = 0               # fan-in axis for normal init
    dtype: Optional[str] = None       # override config dtype (e.g. fp32 norms)


def unflatten(flat: Dict[str, Any]) -> Params:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: Params = {}
    for name, v in flat.items():
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten(tree: Params, prefix: str = "") -> Dict[str, Any]:
    """Inverse of ``unflatten``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Statistics in float32; the result in x's dtype times the scale
    cast to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    """``rope_freqs`` as a float32 tensor on ``device``, copied there
    once: a layer loop then makes no host-to-device copy (which would
    synchronise the stream)."""
    return torch.from_numpy(np.asarray(rope_freqs(head_dim, theta),
                                       np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]. The
    rotation runs in float32 (numpy float32 frequencies)."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].float() * freqs          # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate) * x


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r
