"""Model parameters of the dense decoder family: the port of
``repro.models.transformer``'s param schema, init and layer slicing.

Parameters are a nested dict of tensors with the reference's
layer-stacked layout: ``params["layers"]["attn"]["wq"]`` is
[L, d_model, q_dim], norms are float32 and every other weight is
``cfg.dtype`` (``ParamDef.dtype``). Only the family that
``repro_torch.serving.ServeEngine`` accepts is ported — full attention,
dense FFN, no encoder-decoder, no hybrid SSM heads; every other family
raises ``NotImplementedError`` (ROADMAP.md, queue 1).

``init_params`` draws its own weights from a ``torch.Generator`` (JAX's
random bits cannot be replayed in PyTorch); ``params_from_reference``
adopts the JAX package's parameter tree, as numpy arrays, checked by
name, shape and dtype — the route every parity test takes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import ParamDef, Params, flatten, unflatten

VISION_EMBED_DIM = 1152     # stubbed vision tower output (SigLIP-like)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of the ported dense decoder family."""
    if (cfg.attention != "full" or cfg.enc_dec or cfg.hybrid
            or cfg.moe is not None or cfg.family == "ssm"
            or cfg.frontend == "frames"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense full-attention decoder family is "
            "ported (ROADMAP.md, queue 1: the models' forward/training "
            "families)")


def _stack(defs: Dict[str, ParamDef], n: int) -> Dict[str, ParamDef]:
    return {k: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init,
                        d.scale_axis + 1, d.dtype) for k, d in defs.items()}


def _layer_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Defs for one decoder layer (unstacked)."""
    d = cfg.d_model
    defs: Dict[str, ParamDef] = {
        "attn_norm": ParamDef((d,), ("embed",), init="ones",
                              dtype="float32")}
    for k, v in attn_mod.gqa_defs(cfg).items():
        defs[f"attn/{k}"] = v
    defs["ffn_norm"] = ParamDef((d,), ("embed",), init="ones",
                                dtype="float32")
    for k, v in ffn_mod.dense_defs(cfg).items():
        defs[f"ffn/{k}"] = v
    return defs


def param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Flat {"a/b": ParamDef} schema, names and shapes as the reference's
    ``param_defs``."""
    check_supported(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    defs: Dict[str, ParamDef] = {
        "embed": ParamDef((v, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), ("embed",), init="ones",
                               dtype="float32"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    if cfg.frontend == "patches":
        defs["adapter/w"] = ParamDef((VISION_EMBED_DIM, d), (None, "embed"))
        defs["adapter/b"] = ParamDef((d,), ("embed",), init="zeros")
    for k, vdef in _stack(_layer_defs(cfg), cfg.num_layers).items():
        defs[f"layers/{k}"] = vdef
    return defs


def _dtype(d: ParamDef, cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[d.dtype or cfg.dtype]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Fresh parameters on ``device`` (the generator's device): in sorted
    name order, normal weights scaled by fan_in^-0.5 (drawn in float32,
    then cast), ones / zeros where the schema says so."""
    out = {}
    for name, d in sorted(param_defs(cfg).items()):
        dt = _dtype(d, cfg)
        if d.init == "zeros":
            out[name] = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            out[name] = torch.ones(d.shape, dtype=dt, device=device)
        else:
            fan_in = max(1, d.shape[d.scale_axis])
            w = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32)
            out[name] = (w * fan_in ** -0.5).to(dt)
    return unflatten(out)


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                                # a writable copy
    if a.dtype.name == "bfloat16":                 # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(params_np: Dict[str, Any], cfg: ModelConfig,
                          device) -> Params:
    """The JAX package's parameter tree (nested or "a/b"-flat dict of
    numpy arrays) as the port's parameters on ``device``. Every name,
    shape and dtype must be the schema's."""
    flat = flatten(params_np) if any(
        isinstance(v, dict) for v in params_np.values()) else dict(params_np)
    defs = param_defs(cfg)
    if set(flat) != set(defs):
        raise ValueError("parameter names differ from the schema: "
                         f"{sorted(set(flat) ^ set(defs))}")
    out = {}
    for name, d in defs.items():
        a = np.asarray(flat[name])
        want = _dtype(d, cfg)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{name}: shape {a.shape} != {d.shape}")
        t = _to_tensor(a, device)
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {a.dtype} != {want}")
        out[name] = t
    return unflatten(out)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked ``params["layers"]`` subtree."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params["layers"])
