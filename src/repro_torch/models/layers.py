"""Core model layers as pure functions over parameter dicts: the port of
``repro.models.layers``.

Parameters are nested dicts of tensors with the reference's
layer-stacked layout (every leaf of ``params["layers"]`` has a leading
``L`` axis). ``init_from_defs`` draws from a ``torch.Generator`` (JAX's
random bits cannot be replayed in PyTorch).

Attention: ``flash_attention`` and ``attention_decode`` are the
reference's blockwise jnp functions in PyTorch (``_flash_scan_all``,
``_flash_causal_blocks``, the one-token decode), which the CPU always
runs. On CUDA tensors two cases go to the hand-written kernels, chosen
from the call's static arguments: causal self-attention with no window
and no offset (``Sq == Sk``) launches ``kernels.ops.
flash_attention_causal``, and decode with no window launches
``kernels.ops.decode_attention``. Every other CUDA call (non-causal
encoder and cross-attention, sliding windows) runs the blockwise torch
code, which no Pallas kernel of the reference computes either.
``BLOCKWISE`` counts the calls that ran the torch code; the kernels'
launches are counted by ``kernels.ops.LAUNCHES``.

The blockwise code pins q, k and v with the reference's
``constrain_batch`` hints (``repro_torch.parallel.constraints``: the
identity without an active mesh or on a plain tensor). Left out: the
reference's ``jax.checkpoint`` around the scanned chunk bodies (under
autograd the blockwise code keeps each chunk's tensors until the layer's
backward; a remat policy recomputes the layer, which bounds that to one
layer). It changes no value or gradient; ``launch.counting``'s parity
test states the products it adds to the reference's count. The kernel
route is differentiable: ``flash_attention_causal``'s backward is a
kernel too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.parallel.constraints import constrain_batch

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

#: calls of ``flash_attention`` / ``attention_decode`` that ran the
#: blockwise torch code since the last ``reset_blockwise()``: every CPU
#: call, and the CUDA calls the kernels do not take
BLOCKWISE: Dict[str, int] = {"flash": 0, "decode": 0}


def reset_blockwise() -> None:
    for name in BLOCKWISE:
        BLOCKWISE[name] = 0


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones
    scale_axis: int = 0               # fan-in axis for normal init
    dtype: Optional[str] = None       # override config dtype (e.g. fp32 norms)


def init_from_defs(defs: Dict[str, ParamDef], generator: torch.Generator,
                   dtype: torch.dtype, device) -> Params:
    """Fresh parameters on ``device`` (the generator's device), in sorted
    name order: normal weights scaled by fan_in^-0.5 (drawn in float32,
    then cast), ones / zeros where the schema says so. A tensor of three
    or more dims is drawn one leading slice at a time, so the float32
    temporary is one layer's, not the stack's (deepseek's [26, 64, 2048,
    1408] experts would be a 19 GB temporary)."""
    flat = {}
    for name in sorted(defs):
        d = defs[name]
        dt = _DTYPES[d.dtype] if d.dtype else dtype
        if d.init == "zeros":
            flat[name] = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            flat[name] = torch.ones(d.shape, dtype=dt, device=device)
        else:
            scale = max(1, d.shape[d.scale_axis]) ** -0.5
            w = torch.empty(d.shape, dtype=dt, device=device)
            for part in (w if len(d.shape) >= 3 else (w,)):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=device,
                                       dtype=torch.float32) * scale)
            flat[name] = w
    return unflatten(flat)


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


def _rope_freqs_for(head_dim: int, theta: float, device: torch.device
                    ) -> torch.Tensor:
    """``_rope_freqs_on``, or under a ``FakeTensorMode`` a fake copy of
    this mode's own, never cached: a fake tensor must not outlive its
    mode."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return torch.from_numpy(np.asarray(rope_freqs(head_dim, theta),
                                           np.float32)).to(device)
    return _rope_freqs_on(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]. The
    rotation runs in float32 (numpy float32 frequencies)."""
    freqs = _rope_freqs_for(x.shape[-1], float(theta), x.device)
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


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention: the reference's jnp functions, and the
# routes to the kernels on CUDA tensors.
# ---------------------------------------------------------------------------
def _f32_dot(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of operands in their storage dtype with float32
    accumulation, as the reference's ``preferred_element_type=float32``:
    a bf16 operand widens exactly, so every product is exact in float32."""
    return torch.einsum(spec, a.float(), b.float())


def _softmax_block(s, mask, vb, m, l, acc, spec: str):
    """One chunk of the reference's online softmax: ``mask`` (None: all
    visible) at -inf, ``m_safe`` for fully masked rows, p rounded to the
    value dtype for the P.V product."""
    if mask is not None:
        s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + _f32_dot(spec, p.to(vb.dtype), vb)
    return m_new, l_new, acc_new


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, chunk: int, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Blockwise attention (``repro.models.layers.flash_attention``).

    q: [B, Sq, H, Dh]; k, v: [B, Sk, KvH, Dh]; H % KvH == 0 (head
    h = kvh * G + g). ``window > 0`` keeps the last ``window`` keys;
    ``q_offset`` is q[0]'s position relative to k[0]. On a CUDA tensor,
    causal self-attention (no window, no offset, Sq == Sk) launches
    ``flash_attention_causal``; every other call runs the reference's
    blockwise code: the band-skipping causal path when Sq == Sk is a
    multiple of ``chunk`` with more than one chunk, else the scan over
    every KV chunk."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if (q.is_cuda and causal and window == 0 and q_offset == 0
            and sq == sk):
        out = ops.flash_attention_causal(
            q.reshape(b, sq, kvh, h // kvh, dh).contiguous(),
            k.contiguous(), v.contiguous())
        return out.reshape(b, sq, h, dh)
    BLOCKWISE["flash"] += 1
    if causal and q_offset == 0 and sq == sk and sq % chunk == 0 and \
            sq // chunk > 1:
        return _flash_causal_blocks(q, k, v, chunk=chunk, window=window)
    return _flash_scan_all(q, k, v, causal=causal, chunk=chunk,
                           window=window, q_offset=q_offset)


def _flash_scan_all(q, k, v, *, causal: bool, chunk: int, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """The reference's path: every KV chunk for the full q block, with
    causal, window and padding masks."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    dev = q.device
    qf = constrain_batch((q.float() * dh ** -0.5).to(q.dtype).reshape(
        b, sq, kvh, groups, dh))
    nchunks = max(1, (sk + chunk - 1) // chunk)
    pad = nchunks * chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    k, v = constrain_batch(k), constrain_batch(v)
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, sq, kvh, groups), -torch.inf, device=dev)
    l = torch.zeros((b, sq, kvh, groups), device=dev)
    acc = torch.zeros((b, sq, kvh, groups, dh), device=dev)
    for c in range(nchunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        k_pos = c * chunk + torch.arange(chunk, device=dev)
        s = _f32_dot("bqkgd,bckd->bqkgc", qf, kb)         # [B,Sq,KvH,G,C]
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        mask = mask & (k_pos < sk)[None, :]                # kill padding
        m, l, acc = _softmax_block(s, mask[None, :, None, None, :], vb, m,
                                   l, acc, "bqkgc,bckd->bqkgd")
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _flash_causal_blocks(q, k, v, *, chunk: int, window: int = 0
                         ) -> torch.Tensor:
    """The reference's causal path with diagonal-band skipping: q-block i
    takes the unmasked interior chunks [lo, i) (only a window's left edge
    masked) and then its diagonal chunk under the triangular mask."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    nq = sq // chunk
    dev = q.device
    qb = constrain_batch((q.float() * dh ** -0.5).to(q.dtype).reshape(
        b, nq, chunk, kvh, groups, dh))
    kc = constrain_batch(k.reshape(b, nq, chunk, kvh, dh))
    vc = constrain_batch(v.reshape(b, nq, chunk, kvh, dh))
    wchunks = (window + chunk - 1) // chunk if window else nq
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=dev)
    tri = torch.tril(ones)
    if window:
        tri = tri & ~torch.tril(ones, -window)
    ar = torch.arange(chunk, device=dev)
    spec_s, spec_o = "bqkgd,bckd->bqkgc", "bqkgc,bckd->bqkgd"
    outs = []
    for i in range(nq):
        lo = max(0, i - wchunks) if window else 0
        m = torch.full((b, chunk, kvh, groups), -torch.inf, device=dev)
        l = torch.zeros((b, chunk, kvh, groups), device=dev)
        acc = torch.zeros((b, chunk, kvh, groups, dh), device=dev)
        for j in range(lo, i):                   # interior chunks
            s = _f32_dot(spec_s, qb[:, i], kc[:, j])
            edge = None
            if window:
                edge = ((j * chunk + ar)[None, :]
                        > (i * chunk + ar)[:, None] - window)
                edge = edge[None, :, None, None, :]
                s = torch.where(edge, s, -torch.inf)
            m, l, acc = _softmax_block(s, None, vc[:, j], m, l, acc, spec_o)
        s = _f32_dot(spec_s, qb[:, i], kc[:, i])   # the diagonal chunk
        s = torch.where(tri[None, :, None, None, :], s, -torch.inf)
        m, l, acc = _softmax_block(s, None, vc[:, i], m, l, acc, spec_o)
        outs.append(acc / l.clamp(min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)                 # [B, NQ, C, KvH, G, Dh]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len, *, window: int = 0
                     ) -> torch.Tensor:
    """One-token decode attention (``repro.models.layers.
    attention_decode``). q: [B, 1, H, Dh]; caches [B, T, KvH, Dh];
    ``kv_len`` a scalar (int or 0-d tensor) or [B] count of valid
    entries. On a CUDA tensor with no window it launches
    ``decode_attention`` (q cast to the cache's dtype, as the reference
    casts it); else the reference's masked softmax over the cache."""
    b, _, h, dh = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    groups = h // kvh
    if isinstance(kv_len, int):        # a device fill, not a host copy
        kv_len = torch.full((b,), kv_len, dtype=torch.int32,
                            device=q.device)
    if q.is_cuda and window == 0:
        out = ops.decode_attention(
            q.reshape(b, kvh, groups, dh).to(k_cache.dtype),
            k_cache.contiguous(), v_cache.contiguous(), kv_len)
        return out.reshape(b, 1, h, dh).to(q.dtype)
    BLOCKWISE["decode"] += 1
    qf = (q.float() * dh ** -0.5).to(k_cache.dtype).reshape(b, kvh, groups,
                                                            dh)
    s = _f32_dot("bkgd,btkd->bkgt", qf, k_cache)          # [B,KvH,G,T]
    pos = torch.arange(t, device=q.device)
    kv_len_b = kv_len.expand(b) if kv_len.dim() == 0 else kv_len
    mask = pos[None, :] < kv_len_b[:, None]               # [B, T]
    if window:
        mask = mask & (pos[None, :] >= kv_len_b[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = _f32_dot("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh).to(q.dtype)
