"""Attention parameter schema: ``gqa_defs`` of ``repro.models.attention``.
The GQA forward of the serving path lives in
``repro_torch.serving.engine`` and attends through the kernels."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef


def gqa_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, q, kv, dh = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    defs = {
        "wq": ParamDef((d, q), ("embed", "q_proj")),
        "wk": ParamDef((d, kv), ("embed", "kv_proj")),
        "wv": ParamDef((d, kv), ("embed", "kv_proj")),
        "wo": ParamDef((q, d), ("q_proj", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((dh,), (None,), init="ones", dtype="float32")
        defs["k_norm"] = ParamDef((dh,), (None,), init="ones", dtype="float32")
    return defs
