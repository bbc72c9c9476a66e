"""Attention modules: GQA (with optional qk-norm / sliding window) and
DeepSeek-style MLA (multi-head latent attention) with absorbed decode —
the port of ``repro.models.attention``.

Each module exposes:
  defs(cfg)            -> {name: ParamDef}     (param schema, incl. logical axes)
  fwd(p, x, ...)       -> output               (train / prefill; returns KV)
  decode(p, x, cache)  -> output, new_cache    (single-token step)

Attention goes through ``layers.flash_attention`` /
``layers.attention_decode``, which route CUDA tensors to the kernels.
Decode steps write the cache in place and return the same dict, where
the reference's pure functions return a fresh one: an out-of-place
update would copy every layer's whole cache for each token. The cache
length ``len`` stays a 0-d device tensor, so a decode step makes no host
join. A write past the end of a global cache lands on its last slot, as
``jax.lax.dynamic_update_slice`` clamps its start index.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamDef, apply_rope, attention_decode,
                                       flash_attention, rms_norm)


def _update_at(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor
               ) -> None:
    """``dynamic_update_slice(cache, new, (0, start, 0, ...))`` for a
    one-position ``new`` [B, 1, ...]: the start clamped to [0, T - 1],
    written in place. A DTensor cache whose time axis is sharded (the
    reference's sequence-sharded decode cache) takes
    ``_update_time_sharded``."""
    idx = start.clamp(0, cache.shape[1] - 1).reshape(1).long()
    if any(p.is_shard(1) for p in getattr(cache, "placements", ())):
        _update_time_sharded(cache, new, idx)
        return
    cache.index_copy_(1, idx, new.to(cache.dtype))


def _update_time_sharded(cache, new, idx) -> None:
    """The write on a DTensor cache sharded on its time axis: each rank
    writes the position into its own shard iff the shard holds it (what
    XLA's partitioned ``dynamic_update_slice`` does; DTensor has no
    strategy for an ``index_copy_`` along a sharded dim). ``new`` and
    ``idx`` are brought to the cache's placements with the time axis
    whole."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    with unset_fake_temporarily():          # the offsets are host ints
        shape, offset = compute_local_shape_and_global_offset(
            cache.shape, mesh, pl)
    local = cache.to_local()                # aliases the shard
    whole_t = [Replicate() if p.is_shard(1) else p for p in pl]
    new_l = new.redistribute(mesh, whole_t).to_local().to(cache.dtype)
    rel = idx.redistribute(mesh, [Replicate()] * len(pl)).to_local() \
        - offset[1]
    inside = (rel >= 0) & (rel < shape[1])
    pos = rel.clamp(0, shape[1] - 1)
    keep = local.index_select(1, pos)
    local.index_copy_(1, pos, torch.where(
        inside.reshape((1, 1) + (1,) * (local.dim() - 2)), new_l, keep))


def _split_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t`` [..., H * Dh] viewed as ``shape`` [..., H, Dh]. A DTensor
    whose packed last dim is split over a mesh dim that does not divide
    H is first gathered on that mesh dim: DTensor's view cannot reshard
    (XLA's reshape does), and DTensor may split a product's output over
    ``model`` where the reference's heads do not divide the TP degree.
    A plain tensor is only viewed."""
    placements = tuple(getattr(t, "placements", ()))
    if placements:
        from torch.distributed.tensor import Replicate
        sizes, last, h = tuple(t.device_mesh.shape), t.dim() - 1, shape[-2]
        want = tuple(Replicate() if p.is_shard(last) and h % sizes[i] else p
                     for i, p in enumerate(placements))
        if want != placements:
            t = t.redistribute(t.device_mesh, want)
    return t.reshape(shape)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
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


def gqa_project(p, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, rope: bool = True):
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], b, s, h, dh)
    k = _split_heads(x @ p["wk"], b, s, kvh, dh)
    v = _split_heads(x @ p["wv"], b, s, kvh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
            window: int = 0, positions: Optional[torch.Tensor] = None,
            kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            rope: bool = True
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (train / prefill). Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    q, k, v = gqa_project(p, x, cfg, positions, rope=rope)
    if kv_override is not None:            # cross-attention: KV from encoder
        k, v = kv_override
        causal = False
    out = flash_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                          window=window)
    out = out.reshape(b, s, cfg.q_dim) @ p["wo"]
    return out, (k, v)


def gqa_decode(p, x: torch.Tensor, cfg: ModelConfig,
               cache: Dict[str, torch.Tensor], *, window: int = 0,
               rope: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, 1, D]. cache: {"k": [B,T,KvH,Dh], "v": ..., "len": [] int32},
    updated in place and returned.

    For sliding-window layers the cache is a ring buffer of size window
    (slot ``len % t``, all t entries valid once ``len >= t``); for global
    layers it is the full T buffer."""
    b = x.shape[0]
    t = cache["k"].shape[1]
    kv_len = cache["len"]
    positions = kv_len.reshape(1, 1).expand(b, 1)          # [B, 1]
    q, k, v = gqa_project(p, x, cfg, positions, rope=rope)
    slot = torch.remainder(kv_len, t) if window else kv_len
    _update_at(cache["k"], k, slot)
    _update_at(cache["v"], v, slot)
    new_len = kv_len + 1
    valid = new_len.clamp(max=t) if window else new_len
    out = attention_decode(q, cache["k"], cache["v"], valid, window=0)
    out = out.reshape(b, 1, cfg.q_dim) @ p["wo"]
    kv_len.copy_(new_len)
    return out, cache


def gqa_decode_cross(p, x: torch.Tensor, cfg: ModelConfig,
                     enc_kv: Tuple[torch.Tensor, torch.Tensor],
                     enc_len) -> torch.Tensor:
    """Cross-attention during decode: static encoder KV, no cache update."""
    b = x.shape[0]
    q, _, _ = gqa_project(p, x, cfg, None, rope=False)
    out = attention_decode(q, enc_kv[0], enc_kv[1], enc_len)
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV cache + absorbed decode.
# ---------------------------------------------------------------------------
def mla_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    return {
        "wq": ParamDef((d, qd), ("embed", "q_proj")),
        "w_dkv": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones",
                            dtype="float32"),
        "w_uk": ParamDef((m.kv_lora_rank, h * m.qk_nope_head_dim),
                         ("kv_lora", "q_proj")),
        "w_uv": ParamDef((m.kv_lora_rank, h * m.v_head_dim),
                         ("kv_lora", "q_proj")),
        "wo": ParamDef((h * m.v_head_dim, d), ("q_proj", "embed")),
    }


def _mla_q(p, x, cfg, positions):
    m = cfg.mla
    b, s, _ = x.shape
    q = _split_heads(x @ p["wq"], b, s, cfg.num_heads,
                     m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                             dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, x, cfg, positions):
    m = cfg.mla
    ckv, k_rope = (x @ p["w_dkv"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)
    return ckv, k_rope[..., 0, :]          # [B,S,lora], [B,S,rope_dim]


def mla_fwd(p, x: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill MLA: expand K/V then attend at head dim
    nope + rope (192 at full width), v zero-padded to it and the output
    sliced back. Returns (out, (ckv, k_rope)) — the *compressed* cache.
    q, k and the padded v are fresh contiguous tensors, as the kernel
    needs them."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    if positions is None:
        positions = _positions(b, s, x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, k_rope = _mla_ckv(p, x, cfg, positions)
    k_nope = _split_heads(ckv @ p["w_uk"], b, s, h, m.qk_nope_head_dim)
    v = _split_heads(ckv @ p["w_uv"], b, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    dh = m.qk_nope_head_dim + m.qk_rope_head_dim
    # zero columns by a concatenation, not F.pad: torch's DTensor gives
    # constant_pad_nd's output a malformed spec on a 2-D mesh
    v_pad = torch.cat([v, v.new_zeros(v.shape[:-1] + (dh - m.v_head_dim,))],
                      dim=-1)
    out = flash_attention(q, k, v_pad, causal=True, chunk=cfg.attn_chunk)
    out = out[..., :m.v_head_dim].reshape(b, s, h * m.v_head_dim) @ p["wo"]
    return out, (ckv, k_rope)


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-matrix decode: score and value in the latent space
    against the compressed cache, in float32 einsums (no kernel: the
    reference computes them outside any Pallas kernel).

    cache: {"ckv": [B,T,lora], "k_rope": [B,T,rope], "len": []},
    updated in place and returned."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    kv_len = cache["len"]
    positions = kv_len.reshape(1, 1).expand(b, 1)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)          # [B,1,H,*]
    ckv_new, kr_new = _mla_ckv(p, x, cfg, positions)
    _update_at(cache["ckv"], ckv_new, kv_len)
    _update_at(cache["k_rope"], kr_new, kv_len)
    ckv, kr = cache["ckv"], cache["k_rope"]
    new_len = kv_len + 1
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), w_uk.float())
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s_nope = torch.einsum("bhl,btl->bht", q_lat, ckv.float())
    s_rope = torch.einsum("bhd,btd->bht", q_rope[:, 0].float(), kr.float())
    s = (s_nope + s_rope) * scale
    t = ckv.shape[1]
    mask = torch.arange(t, device=x.device)[None, None, :] < new_len
    s = torch.where(mask, s, -torch.inf)
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bht,btl->bhl", prob, ckv.float())
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhl,lhd->bhd", o_lat, w_uv.float())
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]
    kv_len.copy_(new_len)
    return out, cache
