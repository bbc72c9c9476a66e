"""Grouped-query flash-decode attention: the CUDA kernel and its plain
PyTorch version.

The port of ``repro.kernels.decode_attention`` (the Pallas kernel
``decode_attention``): one query token per sequence attending over a KV
cache masked at ``kv_len``,

    q      [B, KvH, G, Dh]   f32 or bf16 (query head h = kvh * G + g)
    k, v   [B, T, KvH, Dh]   q's dtype
    kv_len [B] i32 (or a scalar): keys [0, kv_len[b]) are visible
    out    [B, KvH, G, Dh]   q's dtype

computed as the Pallas kernel computes it, not as ``ref.py`` does: q is
upcast to float32 and scaled by ``Dh^-0.5``, the softmax runs online in
float32 over blocks of keys (running max, sum and accumulator; masked
scores at -inf; ``m_safe`` keeps a fully masked row finite), and the
output is ``acc / max(l, 1e-30)`` in q's dtype — so a row with nothing
visible (``kv_len = 0``) gives zeros, not NaN.

The wrapper takes the plain version only for CPU tensors. For CUDA
tensors it launches the kernel (``csrc/decode_attention.cu``, built on
first use by ``_build``) or raises; each launch adds one to
``LAUNCHES["decode_attention"]``. The kernel is bound by bytes on the
H100 (G <= 32 flops per byte read): it splits each sequence's keys over
a cluster of 8 blocks, keeps several 16-byte K/V loads in flight per
lane on the CUDA cores in float32, and merges the blocks' partial
softmaxes in rank order through distributed shared memory — no atomics,
so repeated calls give the same bits and nothing past ``kv_len`` is
read.

The call is an operator of its own (``torch.ops.repro_torch.
decode_attention``, defined with ``torch.library.Library``: one
implementation on the CPU and CUDA keys and a fake one), so a dispatch
mode sees it as one op, a ``FakeTensor`` call returns shapes without
touching the kernel, and a ``DTensor`` call runs on the local shards by
the rule ``launch.mesh`` registers (batch and KV heads shard).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import count

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_G, MAX_DH = 32, 128         # the kernel's limits (csrc/attention.cuh)


def kv_len_vector(kv_len, b: int, device) -> torch.Tensor:
    """``kv_len`` as an int32 [B] tensor on ``device`` (a scalar repeats,
    as in the Pallas wrapper)."""
    kv_len = torch.as_tensor(kv_len, device=device)
    if kv_len.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"kv_len must be an integer, got {kv_len.dtype}")
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(b)
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be a scalar or [B={b}], got "
                         f"{tuple(kv_len.shape)}")
    return kv_len.to(torch.int32).contiguous()


def online_softmax_step(s, mask, v, m, l, acc, spec: str):
    """One block of the Pallas kernels' float32 online softmax: scores
    ``s`` (masked at -inf where ``mask`` is False), values ``v`` and the
    running (max ``m``, sum ``l``, accumulator ``acc``); ``spec`` is the
    einsum of p against v. Returns the new (m, l, acc)."""
    s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(spec, p, v)
    return m_new, l, acc


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len, block_t: int = 512
                           ) -> torch.Tensor:
    """The Pallas kernel's arithmetic in PyTorch, block by block of
    ``block_t`` keys (the CPU path and the kernel's oracle)."""
    b, kvh, g, dh = q.shape
    t = k.shape[1]
    kv_len = kv_len_vector(kv_len, b, q.device)
    qf = q.float() * dh ** -0.5
    m = torch.full((b, kvh, g), -torch.inf, device=q.device)
    l = torch.zeros((b, kvh, g), device=q.device)
    acc = torch.zeros((b, kvh, g, dh), device=q.device)
    for t0 in range(0, t, block_t):
        kb = k[:, t0:t0 + block_t].float()
        vb = v[:, t0:t0 + block_t].float()
        s = torch.einsum("bhgd,bthd->bhgt", qf, kb)
        pos = torch.arange(t0, t0 + kb.shape[1], device=q.device)
        mask = (pos[None, :] < kv_len[:, None])[:, None, None, :]
        m, l, acc = online_softmax_step(s, mask, vb, m, l, acc,
                                        "bhgt,bthd->bhgd")
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def check_attention_inputs(name: str, q, k, v, q_dims: int) -> None:
    """Ranks, dtypes, the shared (KvH, Dh) and one device."""
    if q.dim() != q_dims or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: bad ranks q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} != v "
                         f"{tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: all inputs must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {q.device}")


def check_kernel_limits(name: str, tensors, g: int, dh: int,
                        max_dh: int) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device "
                         f"{tensors[0].device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not (1 <= g <= MAX_G and 1 <= dh <= max_dh):
        raise ValueError(f"{name}: the kernel takes 1 <= G <= {MAX_G} and "
                         f"1 <= Dh <= {max_dh}, got G={g}, Dh={dh}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """GQA decode attention (see the module doc)."""
    check_attention_inputs("decode_attention", q, k, v, 4)
    b, kvh, g, dh = q.shape
    if k.shape[0] != b or k.shape[2] != kvh or k.shape[3] != dh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    kv_len = kv_len_vector(kv_len, b, q.device)
    return torch.ops.repro_torch.decode_attention(q, k, v, kv_len)


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_len: torch.Tensor) -> torch.Tensor:
    """The operator's implementation: the plain version on CPU tensors,
    else one launch of the kernel (``kv_len`` int32 [B])."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    b, kvh, g, dh = q.shape
    check_kernel_limits("decode_attention", (q, k, v), g, dh, MAX_DH)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.call("decode_attention", f"decode_attention_{_SUFFIX[q.dtype]}",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_float],
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), b, k.shape[1], kvh, g, dh, dh ** -0.5],
                q.device)
    count("decode_attention")
    return out


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor kv_len)"
            " -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("decode_attention", _decode, _key)


@torch.library.register_fake("repro_torch::decode_attention", lib=_LIB)
def _decode_fake(q, k, v, kv_len):
    return q.new_empty(q.shape)
