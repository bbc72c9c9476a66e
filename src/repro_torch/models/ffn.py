"""FFN modules: dense (SwiGLU / squared-ReLU / GeGLU / GELU) and
token-choice MoE — the port of ``repro.models.ffn``.

The MoE dispatch is the reference's sort-free one: per-expert ranks from
a cumulative sum over a one-hot [tokens * k, E] matrix, tokens scattered
into a capacity-bounded [E, C, D] buffer (overflow dropped), the experts
as batched matrix products (``torch.bmm``, as the reference leaves its
einsums to XLA), results gathered back and mixed by the renormalised
top-k weights. The top-k is a stable descending sort, so tied router
probabilities pick the lower expert index first, as ``jax.lax.top_k``
does. Every step is a device operation: a decode step makes no host
join. The tokens are pinned with the reference's ``constrain_batch``
hint (the identity without an active mesh).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import ParamDef, grad_as_forward, squared_relu
from repro_torch.parallel.constraints import constrain_batch, one_axis_batch


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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.num_experts, mo.d_ff_expert
    defs = {
        "router": ParamDef((d, e), ("embed", None), dtype="float32"),
        "w1": ParamDef((e, d, f), ("experts", "embed", "expert_mlp"),
                       scale_axis=1),
        "w3": ParamDef((e, d, f), ("experts", "embed", "expert_mlp"),
                       scale_axis=1),
        "w2": ParamDef((e, f, d), ("experts", "expert_mlp", "embed"),
                       scale_axis=1),
    }
    if mo.num_shared:
        fs = mo.num_shared * f
        defs["shared_w1"] = ParamDef((d, fs), ("embed", "mlp"))
        defs["shared_w3"] = ParamDef((d, fs), ("embed", "mlp"))
        defs["shared_w2"] = ParamDef((fs, d), ("mlp", "embed"))
    return defs


def _gate(h: torch.Tensor, gate: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    if cfg.activation in ("swiglu",):
        return torch.nn.functional.silu(gate) * h
    return _gelu(gate) * h


def moe_capacity(mo: MoEConfig, num_tokens: int) -> int:
    c = int(num_tokens * mo.top_k * mo.capacity_factor / mo.num_experts)
    return max(8, (c + 7) // 8 * 8)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties broken
    toward the lower index (a stable descending sort)."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def moe_fwd(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss scalar).

    Capacity-based token-choice routing with overflow drop (dropped
    tokens fall through via the residual / shared experts) and the
    Switch-style load-balancing loss."""
    mo = cfg.moe
    b, s, d = x.shape
    tokens = b * s
    e, k = mo.num_experts, mo.top_k
    dev = x.device
    xt = constrain_batch(x.reshape(tokens, d))

    logits = xt.float() @ p["router"]                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, k)                           # [T, k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)                                        # [E]
    flat_e = top_i.reshape(-1)                                # [T*k]
    ce = me.new_zeros(e).index_add_(
        0, flat_e, torch.full(flat_e.shape, 1.0 / (tokens * k), device=dev))
    aux = e * torch.sum(me * ce)

    # --- dispatch ---------------------------------------------------------
    c = moe_capacity(mo, tokens)
    onehot = (flat_e[:, None] == torch.arange(e, device=dev)).to(
        torch.int32)                                          # [T*k, E]
    rank = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    rank = rank.gather(1, flat_e[:, None])[:, 0]              # rank BEFORE self
    keep = rank < c
    # the slots sharded over one mesh dim at most: torch's DTensor has no
    # index_select strategy (the combine, and the dispatch's backward) for
    # indices sharded over two
    slot = one_axis_batch(torch.where(keep, flat_e * c + rank, e * c))
    xr = xt.repeat_interleave(k, dim=0)                       # [T*k, D]
    buf = xt.new_zeros((e * c + 1, d)).index_add_(
        0, slot, torch.where(keep[:, None], xr, 0))
    # the gradient back in the buffer's own placements before the view's
    # backward: under expert-internal TP (experts not sharded, their d_ff
    # over ``model``) DTensor returns it sharded on the expert dim, which
    # the [E * C, D] view cannot take where ``data`` does not divide E
    buf = grad_as_forward(buf[:-1].reshape(e, c, d))

    # --- expert compute (batched matmul) ------------------------------------
    h = torch.bmm(buf, p["w1"])
    g = torch.bmm(buf, p["w3"])
    h = _gate(h, g, cfg)
    eo = torch.bmm(h, p["w2"])                                # [E, C, D]

    # --- combine ------------------------------------------------------------
    eo_flat = torch.cat([eo.reshape(e * c, d),
                         torch.zeros((1, d), dtype=eo.dtype, device=dev)])
    back = eo_flat.index_select(0, slot).reshape(tokens, k, d)
    out = torch.sum(back * top_w[..., None].to(back.dtype), dim=1)

    if mo.num_shared:
        sh = xt @ p["shared_w1"]
        sh = _gate(sh, xt @ p["shared_w3"], cfg) if "shared_w3" in p else sh
        out = out + sh @ p["shared_w2"]
    return out.reshape(b, s, d), aux
