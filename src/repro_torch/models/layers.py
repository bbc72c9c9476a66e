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

Every split of the query heads into (KvH, G) goes through
``split_groups`` and every merge back through ``merge_groups``: on a
DTensor whose heads shard over a mesh dim that divides H but not KvH
(``model`` = 16 against 8 KV heads) they gather the heads first; on a
plain tensor they are the reshapes they replace.

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
#: ``_f32_dot``'s gradient pin on DTensors: torch before 2.13 only
_PIN_PRODUCT_GRADS = torch.torch_version.TorchVersion(
    torch.__version__) < (2, 13)


def grad_as_forward(t: torch.Tensor) -> torch.Tensor:
    """``t``, and on a DTensor that takes a gradient, ``t`` through a
    ``redistribute`` to its own placements: nothing moves forward, and
    the backward brings the gradient to ``t``'s placements before the
    op that made ``t`` runs its backward (whose reshapes torch 2.11's
    DTensor cannot run on every placement a gradient may arrive in)."""
    if t.requires_grad and getattr(t, "placements", None):
        return t.redistribute(t.device_mesh, t.placements)
    return t


class _ContiguousGrad(torch.autograd.Function):
    """The identity forward; backward, the gradient copied into the
    contiguous layout, so that the op before it reshapes a gradient
    whose local layout is the one its global strides describe (a
    DTensor gradient built by elementwise ops on a permuted product can
    hold a local layout its global strides do not describe, and
    DTensor then views where it must copy)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clone(memory_format=torch.contiguous_format)


def _f32_dot(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of operands in their storage dtype with float32
    accumulation, as the reference's ``preferred_element_type=float32``:
    a bf16 operand widens exactly, so every product is exact in float32.
    On DTensors the product's gradient is made contiguous before the
    einsum's backward reshapes it (``_ContiguousGrad``), and under torch
    2.11 (``_PIN_PRODUCT_GRADS``) it comes back in the product's own
    placements (``grad_as_forward``):
    that DTensor cannot run the einsum's backward reshapes on every
    placement a gradient may arrive in. torch 2.13's can, and there the
    same pin breaks a real sharded backward (its redistributed gradient
    of a permuted product holds a local layout that its global strides
    do not describe), so it is left out."""
    out = torch.einsum(spec, a.float(), b.float())
    if not getattr(out, "placements", None):
        return out
    if out.requires_grad:
        out = _ContiguousGrad.apply(out)
    return grad_as_forward(out) if _PIN_PRODUCT_GRADS else out


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


def split_groups(t: torch.Tensor, kvh: int) -> torch.Tensor:
    """``t`` [..., H, Dh] as [..., KvH, G, Dh], G = H // KvH (head
    h = kvh * G + g), the grouped-query split the kernels and the
    blockwise code take. A DTensor whose H dim is sharded over a mesh dim
    that does not divide KvH is first replicated on that mesh dim:
    DTensor's view cannot reshard (XLA's reshape does), and the query
    heads shard over ``model`` wherever it divides H, which need not
    divide KvH (``models.attention._split_heads`` does the same for the
    projections). A plain tensor is only reshaped (a view where its
    strides allow), so its bits and launches do not change."""
    *lead, h, dh = t.shape
    placements = tuple(getattr(t, "placements", ()))
    if placements:
        from torch.distributed.tensor import Replicate
        sizes, hdim = tuple(t.device_mesh.shape), t.dim() - 2
        want = tuple(Replicate() if p.is_shard(hdim) and kvh % sizes[i]
                     else p for i, p in enumerate(placements))
        if want != placements:
            t = t.redistribute(t.device_mesh, want)
    return t.reshape(*lead, kvh, h // kvh, dh)


def merge_groups(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t`` [..., KvH, G, Dh] reshaped to ``shape`` [..., H, Dh], the
    inverse of ``split_groups``. A DTensor on a mesh with a dim that does
    not divide KvH takes its gradient back in its own placements
    (``grad_as_forward``) before the reverse split: a gradient sharded
    on H over such a dim cannot be split by a view. A plain tensor is
    only reshaped."""
    out = t.reshape(shape)
    if getattr(out, "placements", None) and any(
            t.shape[-3] % n for n in tuple(out.device_mesh.shape)):
        return grad_as_forward(out)
    return out


def heads_whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, S, heads, Dh] with its heads dim whole, for the blockwise
    code: its einsums batch over (B, KvH), and torch 2.11's DTensor
    flattens two batch dims into one only while at most the leading one
    is sharded. A DTensor whose heads dim is sharded (16 KV heads on
    ``model`` = 16) is gathered on those mesh dims; anything else is
    returned as it is."""
    placements = tuple(getattr(t, "placements", ()))
    if not any(p.is_shard(2) for p in placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_shard(2) else p for p in placements))


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
            split_groups(q, kvh).contiguous(),
            k.contiguous(), v.contiguous())
        return merge_groups(out, b, sq, h, dh)
    BLOCKWISE["flash"] += 1
    q, k, v = heads_whole(q), heads_whole(k), heads_whole(v)
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
    qf = constrain_batch(split_groups(
        (q.float() * dh ** -0.5).to(q.dtype), kvh))
    nchunks = max(1, (sk + chunk - 1) // chunk)
    pad = nchunks * chunk - sk
    if pad:
        # trailing zeros by a concatenation, not F.pad: torch 2.11's
        # DTensor gives constant_pad_nd's output a malformed spec on a
        # mesh (a later view of it fails)
        k = torch.cat([k, k.new_zeros((b, pad) + k.shape[2:])], dim=1)
        v = torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
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
    return merge_groups(out, b, sq, h, dh).to(q.dtype)


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
    qb = constrain_batch(split_groups(
        (q.float() * dh ** -0.5).to(q.dtype), kvh).reshape(
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
    return merge_groups(out, b, sq, h, dh).to(q.dtype)


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
            split_groups(q, kvh).reshape(b, kvh, groups, dh).to(
                k_cache.dtype),
            k_cache.contiguous(), v_cache.contiguous(), kv_len)
        return merge_groups(out, b, 1, h, dh).to(q.dtype)
    BLOCKWISE["decode"] += 1
    q, k_cache, v_cache = (heads_whole(q), heads_whole(k_cache),
                           heads_whole(v_cache))
    qf = split_groups((q.float() * dh ** -0.5).to(k_cache.dtype),
                      kvh).reshape(b, kvh, groups, dh)
    s = _f32_dot("bkgd,btkd->bkgt", qf, k_cache)          # [B,KvH,G,T]
    pos = torch.arange(t, device=q.device)
    kv_len_b = kv_len.expand(b) if kv_len.dim() == 0 else kv_len
    mask = pos[None, :] < kv_len_b[:, None]               # [B, T]
    if window:
        mask = mask & (pos[None, :] >= kv_len_b[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = _f32_dot("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return merge_groups(out, b, 1, h, dh).to(q.dtype)
