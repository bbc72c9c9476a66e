"""Causal grouped-query flash attention (prefill): the CUDA kernel and its
plain PyTorch version.

The port of ``repro.kernels.flash_attention`` (the Pallas kernel
``flash_attention_causal``):

    q    [B, S, KvH, G, Dh]   f32 or bf16 (query head h = kvh * G + g)
    k, v [B, S, KvH, Dh]      q's dtype
    out  [B, S, KvH, G, Dh]   q's dtype

query position i attends to keys 0..i. Computed as the Pallas kernel
computes it: q upcast to float32 and scaled by ``Dh^-0.5``, a float32
online softmax over key blocks, blocks strictly above the diagonal
skipped, the triangular mask on the diagonal, ``m_safe`` and the output
``acc / max(l, 1e-30)`` in q's dtype. Unlike the Pallas wrapper, which
asserts ``S % block == 0``, both versions take any S.

The wrapper takes the plain version only for CPU tensors. For CUDA
tensors it launches one of two hand-written kernels of
``csrc/flash_attention.cu`` (built on first use by ``_build``) or raises;
``flash_route`` picks it:

* ``"wgmma"`` — bf16 with Dh a multiple of 16 (up to 192) and 16-byte
  aligned tensors: the tensor cores (wgmma, TMA loads into a ring of tiles, the
  softmax in registers), P rounded to bf16 for the P.V product;
* ``"cuda_cores"`` — float32 (TF32 would not hold its 1e-5 tolerance) and
  bf16 with any other Dh: the float32 CUDA-core kernel of
  ``csrc/attention.cuh``.

Both replace the Pallas kernel; the choice is by dtype and shape, never a
fallback after a failure. Each launch adds one to
``LAUNCHES["flash_attention_causal"]`` and one to the route's own count,
``LAUNCHES["flash_attention_causal/<route>"]``. What bounds the kernels
on the H100 (operations, at the serving shapes) and what each design
does about it is in the source's header note.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES
from repro_torch.kernels.decode_attention import (_SUFFIX,
                                                  check_attention_inputs,
                                                  check_kernel_limits,
                                                  online_softmax_step)

#: the flash kernels' head-dim limit, above decode's 128: DeepSeek-V2's
#: MLA prefill attends at 128 + 64 = 192 (csrc/flash_attention.cu)
MAX_DH = 192


def flash_attention_causal_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, block_q: int = 256,
                                 block_k: int = 256) -> torch.Tensor:
    """The Pallas kernel's arithmetic in PyTorch, q block by q block and
    key block by key block (the CPU path and the kernel's oracle)."""
    b, s, kvh, g, dh = q.shape
    qf = q.float() * dh ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block_q):
        q1 = min(s, q0 + block_q)
        qb = qf[:, q0:q1]
        q_pos = torch.arange(q0, q1, device=q.device)
        m = torch.full((b, q1 - q0, kvh, g), -torch.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, q1 - q0, kvh, g, dh), device=q.device)
        for k0 in range(0, q1, block_k):          # causal block skip
            k1 = min(s, k0 + block_k)
            sc = torch.einsum("bqhgd,bkhd->bqhgk", qb, kf[:, k0:k1])
            k_pos = torch.arange(k0, k1, device=q.device)
            mask = (k_pos[None, :] <= q_pos[:, None])[None, :, None, None]
            m, l, acc = online_softmax_step(sc, mask, vf[:, k0:k1], m, l,
                                            acc, "bqhgk,bkhd->bqhgd")
        out[:, q0:q1] = acc / l.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor | None = None) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 with
    ``Dh % 16 == 0`` and 16-byte aligned tensors (TMA and the 16-byte Q
    loads need it), else ``"cuda_cores"``."""
    tensors = (q, k, v) if out is None else (q, k, v, out)
    aligned = all(x.data_ptr() % 16 == 0 for x in tensors)
    if q.dtype == torch.bfloat16 and q.shape[-1] % 16 == 0 and aligned:
        return "wgmma"
    return "cuda_cores"


def flash_attention_causal(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention over one sequence per batch row (see the
    module doc)."""
    check_attention_inputs("flash_attention_causal", q, k, v, 5)
    b, s, kvh, g, dh = q.shape
    if tuple(k.shape) != (b, s, kvh, dh):
        raise ValueError(f"flash_attention_causal: q {tuple(q.shape)} does "
                         f"not match k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_attention_causal_plain(q, k, v)
    check_kernel_limits("flash_attention_causal", (q, k, v), g, dh, MAX_DH)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = flash_route(q, k, v, out)
    fn_name = f"flash_attention_causal_{_SUFFIX[q.dtype]}"
    if route == "wgmma":
        fn_name += "_wgmma"
    _build.call("flash_attention", fn_name,
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_float],
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, kvh, g, dh, dh ** -0.5], q.device)
    LAUNCHES["flash_attention_causal"] += 1
    LAUNCHES[f"flash_attention_causal/{route}"] += 1
    return out
