"""Mamba-2 SSD (state-space duality) block: the chunked dual form for
train / prefill and the O(1)-per-token recurrent decode — the port of
``repro.models.ssm`` [arXiv:2405.21060].

Within a chunk the contribution is an attention-like quadratic term
masked by the cumulative decay; across chunks a small recurrent state
[B, nh, hd, ds] is carried by a loop over chunks. The reference's
three-operand einsums are contracted pairwise in a fixed order, so no
[B, NC, Q, Q, nh, hd] intermediate is ever formed (at mamba2-370m's full
width that would be ~4 GB a batch row at S = 2048): the decay mask
times C.B first (the size of the mask), then one batched product with
x.dt; the chunk states weight x first, then contract over positions;
the inter-chunk term contracts C with the carried state, then scales.
Like the reference, ``ssd_chunked`` needs S to be a multiple of the
chunk (256 at full width), and pins its chunked x with the reference's
``constrain_batch`` hint (the identity without an active mesh).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, rms_norm
from repro_torch.parallel.constraints import constrain_batch


def ssm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return {
        # fused in_proj -> [z, xBC, dt]
        "in_proj": ParamDef((d, 2 * di + 2 * s.n_groups * s.d_state + nh),
                            ("embed", "ssm_inner")),
        "conv_w": ParamDef((s.d_conv, conv_ch), (None, "ssm_inner"),
                           scale_axis=0),
        "conv_b": ParamDef((conv_ch,), ("ssm_inner",), init="zeros"),
        "A_log": ParamDef((nh,), ("ssm_heads",), init="zeros", dtype="float32"),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="zeros",
                            dtype="float32"),
        "D": ParamDef((nh,), ("ssm_heads",), init="ones", dtype="float32"),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones", dtype="float32"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gs = s.n_groups * s.d_state
    z, xBC, dt = zxbcdt.split([di, di + 2 * gs, nh], dim=-1)
    return z, xBC, dt, di, nh, gs


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d, summed in float32. xBC: [B, S, C]; w: [K, C]."""
    k, s = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(k):
        out = out + pad[:, i:i + s, :].float() * w[i].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual form, in float32.

    x: [B, S, nh, hd]; dt: [B, S, nh] (post-softplus); A: [nh] (negative);
    B, C: [B, S, G, ds] with G == 1 (broadcast over heads).
    Returns (y [B, S, nh, hd], final_state [B, nh, hd, ds])."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"ssd_chunked: S={s} is not a multiple of the "
                         f"chunk {chunk}")
    f32 = torch.float32
    xc = constrain_batch(x.reshape(b, nc, chunk, nh, hd).to(f32))
    dtc = dt.reshape(b, nc, chunk, nh).to(f32)
    Bc = B.reshape(b, nc, chunk, ds).to(f32)        # G == 1 squeezed
    Cc = C.reshape(b, nc, chunk, ds).to(f32)

    dA = dtc * A.to(f32)[None, None, None, :]                   # [B,NC,Q,nh]
    seg = torch.cumsum(dA, dim=2)                               # within-chunk
    total = seg[:, :, -1, :]                                    # [B,NC,nh]

    # --- intra-chunk (quadratic) term: L[i,j] = exp(seg_i - seg_j), i >= j
    li = seg[:, :, :, None, :] - seg[:, :, None, :, :]          # [B,NC,Q,Q,nh]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(li), 0.0)
    cb = torch.einsum("bnid,bnjd->bnij", Cc, Bc)                # [B,NC,Q,Q]
    xdt = xc * dtc[..., None]                                   # [B,NC,Q,nh,hd]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", cb[..., None] * L, xdt)

    # --- chunk states -------------------------------------------------------
    decay_to_end = torch.exp(total[:, :, None, :] - seg)        # [B,NC,Q,nh]
    wx = (decay_to_end * dtc)[..., None] * xc                   # [B,NC,Q,nh,hd]
    states = torch.einsum("bnqd,bnqhp->bnhpd", Bc, wx)          # [B,NC,nh,hd,ds]

    # --- inter-chunk recurrence (a loop over chunks) ------------------------
    carry = (torch.zeros((b, nh, hd, ds), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for n in range(nc):
        prev.append(carry)                                      # PREVIOUS
        carry = carry * torch.exp(total[:, n])[..., None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                      # [B,NC,nh,hd,ds]

    # --- inter-chunk contribution -------------------------------------------
    y_inter = torch.einsum("bnqd,bnhpd->bnqhp", Cc, prev_states) \
        * torch.exp(seg)[..., None]

    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    return y, carry


def ssm_fwd(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full Mamba-2 block forward (train / prefill). x: [B, S, D]."""
    s_cfg = cfg.ssm
    z, xBC, dt, di, nh, gs = _split_proj(cfg, x @ p["in_proj"])
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs, B, C = xBC.split([di, gs, gs], dim=-1)
    bsz, slen = xs.shape[0], xs.shape[1]
    xh = xs.reshape(bsz, slen, nh, s_cfg.head_dim)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    Bh = B.reshape(bsz, slen, s_cfg.n_groups, s_cfg.d_state)
    Ch = C.reshape(bsz, slen, s_cfg.n_groups, s_cfg.d_state)
    y, _ = ssd_chunked(xh, dt, A, Bh, Ch, s_cfg.chunk_size)
    y = y + xh.float() * p["D"].float()[..., None]
    y = y.reshape(bsz, slen, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p, x: torch.Tensor, cfg: ModelConfig,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step. x: [B, 1, D]. The cache is updated in
    place and returned."""
    s_cfg = cfg.ssm
    z, xBC, dt, di, nh, gs = _split_proj(cfg, x @ p["in_proj"])
    # conv ring: the cached K-1 inputs and the current one
    window = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)],
                       dim=1)                                   # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    xs, B, C = conv_out.to(x.dtype).split([di, gs, gs], dim=-1)
    bsz = xs.shape[0]
    xh = xs.reshape(bsz, nh, s_cfg.head_dim).float()
    dt1 = _softplus(dt[:, 0].float() + p["dt_bias"].float())   # [B, nh]
    A = -torch.exp(p["A_log"].float())
    Bh = B.reshape(bsz, s_cfg.n_groups, s_cfg.d_state).float()[:, 0]
    Ch = C.reshape(bsz, s_cfg.n_groups, s_cfg.d_state).float()[:, 0]
    decay = torch.exp(dt1 * A[None, :])                         # [B, nh]
    upd = (dt1[..., None] * xh)[..., None] * Bh[:, None, None, :]
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bhpd,bd->bhp", state, Ch)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return y @ p["out_proj"], cache
