"""Dense FFN: ``dense_defs`` / ``dense_fwd`` of ``repro.models.ffn``
(SwiGLU, GeGLU, squared ReLU, GELU). MoE is a later slice."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, squared_relu


def dense_defs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    defs = {
        "w1": ParamDef((d, f), ("embed", "mlp")),
        "w2": ParamDef((f, d), ("mlp", "embed")),
    }
    if cfg.activation in ("swiglu", "geglu"):
        defs["w3"] = ParamDef((d, f), ("embed", "mlp"))
    return defs


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def dense_fwd(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p["w1"]
    if cfg.activation == "swiglu":
        h = torch.nn.functional.silu(x @ p["w3"]) * h
    elif cfg.activation == "geglu":
        h = _gelu(x @ p["w3"]) * h
    elif cfg.activation == "squared_relu":
        h = squared_relu(h)
    else:
        h = _gelu(h)
    return h @ p["w2"]
