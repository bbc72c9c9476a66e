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
tensors it launches one of three hand-written kernels of
``csrc/flash_attention.cu`` (built on first use by ``_build``) or raises;
``flash_route`` picks it:

* ``"wgmma"`` — bf16 with Dh a multiple of 16 (up to 192) and 16-byte
  aligned tensors: the tensor cores (wgmma, TMA loads into a ring of tiles, the
  softmax in registers), P rounded to bf16 for the P.V product;
* ``"tf32x3"`` — float32 with Dh a multiple of 8 (up to 192) and 16-byte
  aligned tensors: the tensor cores in tf32 with float32 accuracy, each
  product a.b taken as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (x_hi = x
  rounded to tf32, x_lo = x - x_hi rounded to tf32; one tf32 product
  alone would not hold float32's 1e-5 tolerance), summed in float32;
* ``"cuda_cores"`` — the rest (bf16 with Dh not a multiple of 16,
  float32 with Dh not a multiple of 8, unaligned tensors): the float32
  CUDA-core kernel of ``csrc/attention.cuh``.

All three replace the Pallas kernel; the choice is by dtype, shape and
alignment, never a fallback after a failure. Each launch adds one to
``LAUNCHES["flash_attention_causal"]`` and one to the route's own count,
``LAUNCHES["flash_attention_causal/<route>"]``. What bounds the kernels
on the H100 (operations, at the serving shapes) and what each design
does about it is in the source's header note.

Both entry points are operators of their own
(``torch.ops.repro_torch.flash_attention_causal`` and ``..._bwd``,
defined with ``torch.library.Library``: one implementation on the CPU
and CUDA keys, which picks plain or kernel by device, and a fake one),
so a dispatch mode sees each call as one op (``launch.counting`` counts
it by its formula), a ``FakeTensor`` call returns shapes without
touching a kernel, and a ``DTensor`` call runs on the local shards by
the rule ``launch.mesh`` registers (batch and KV heads shard, sequence
and Dh replicate).

The gradient: ``flash_attention_causal`` is a ``torch.autograd.Function``
over the forward operator whose backward is ``flash_attention_causal_bwd``
— dq, dk and dv from q, k, v, the forward's output and its gradient,
with a float32 softmax recomputed from the saved inputs. On CUDA tensors
it launches three kernels (row statistics, then dk/dv, then dq; no float
atomics, so the bits repeat) of one of three sources, which
``flash_bwd_route`` picks
by dtype, shape and alignment before the launch:

* ``"wgmma"`` — bf16 with Dh a multiple of 16 up to 192 (MLA's) and
  16-byte aligned tensors: ``csrc/flash_attention_bwd_wgmma.cu``, the
  tensor cores (wgmma, TMA rings; above Dh = 128 the dk/dv kernel splits
  over two consumer warpgroups), P and dS rounded to bf16 for the
  products;
* ``"tf32x3"`` — float32 with Dh a multiple of 8 up to 192 and 16-byte
  aligned tensors: ``csrc/flash_attention_bwd_tf32x3.cu``, the tensor
  cores in tf32 with float32 accuracy (each product a.b as a_hi.b_hi +
  a_hi.b_lo + a_lo.b_hi, as the forward's ``tf32x3`` route; one tf32
  product would not hold the 2e-5 tolerance), TMA-streamed tiles, and
  above Dh = 64 the Dh columns split over a cluster of two blocks;
* ``"cuda_cores"`` — the rest (float32 with Dh not a multiple of 8,
  unaligned tensors, bf16 with Dh not a multiple of 16):
  ``csrc/flash_attention_bwd.cu``'s float32 CUDA-core kernels.

A call counts one ``LAUNCHES["flash_attention_causal_bwd"]``, one
``LAUNCHES["flash_attention_causal_bwd/<route>"]`` and one
``LAUNCHES["flash_attention_causal_bwd/<kernel>"]`` a kernel; a failed
build or launch raises. On CPU tensors it takes
``flash_attention_causal_bwd_plain``. The reference has no Pallas
backward (it differentiates its blockwise jnp attention), so the plain
backward is the oracle.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import count
from repro_torch.kernels.decode_attention import (_SUFFIX,
                                                  check_attention_inputs,
                                                  check_kernel_limits,
                                                  online_softmax_step)

#: the flash kernels' head-dim limit, above decode's 128: DeepSeek-V2's
#: MLA prefill attends at 128 + 64 = 192 (csrc/flash_attention.cu)
MAX_DH = 192
#: the tensor-core backward's head-dim limit (both routes), the forward's:
#: bf16 up to 128 holds dK and dV in one consumer warpgroup, above it
#: (MLA's 192) in two (csrc/flash_attention_bwd_wgmma.cu); float32 above
#: 64 splits Dh over a cluster of two blocks
#: (csrc/flash_attention_bwd_tf32x3.cu)
BWD_WGMMA_MAX_DH = MAX_DH


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
    """The kernel a CUDA call takes, with 16-byte aligned tensors (TMA and
    the 16-byte Q loads need it): ``"wgmma"`` for bf16 with
    ``Dh % 16 == 0``, ``"tf32x3"`` for float32 with ``Dh % 8 == 0``;
    else ``"cuda_cores"``."""
    tensors = (q, k, v) if out is None else (q, k, v, out)
    if all(x.data_ptr() % 16 == 0 for x in tensors):
        dh = q.shape[-1]
        if q.dtype == torch.bfloat16 and dh % 16 == 0:
            return "wgmma"
        if q.dtype == torch.float32 and dh % 8 == 0:
            return "tf32x3"
    return "cuda_cores"


def flash_bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, dout: torch.Tensor) -> str:
    """The kernels a CUDA backward call takes, with all five tensors
    16-byte aligned (TMA needs them) and ``Dh <= BWD_WGMMA_MAX_DH``:
    ``"wgmma"`` for bf16 with ``Dh % 16 == 0``, ``"tf32x3"`` for float32
    with ``Dh % 8 == 0``; else ``"cuda_cores"``."""
    dh = q.shape[-1]
    if (dh <= BWD_WGMMA_MAX_DH
            and all(x.data_ptr() % 16 == 0 for x in (q, k, v, out, dout))):
        if q.dtype == torch.bfloat16 and dh % 16 == 0:
            return "wgmma"
        if q.dtype == torch.float32 and dh % 8 == 0:
            return "tf32x3"
    return "cuda_cores"


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
    """The forward call: the plain version on CPU tensors, else one
    launch of the route's kernel."""
    if q.device.type == "cpu":
        return flash_attention_causal_plain(q, k, v)
    b, s, kvh, g, dh = q.shape
    check_kernel_limits("flash_attention_causal", (q, k, v), g, dh, MAX_DH)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = flash_route(q, k, v, out)
    fn_name = f"flash_attention_causal_{_SUFFIX[q.dtype]}"
    if route != "cuda_cores":
        fn_name += f"_{route}"
    _build.call("flash_attention", fn_name,
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_float],
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, kvh, g, dh, dh ** -0.5], q.device)
    count("flash_attention_causal", f"flash_attention_causal/{route}")
    return out


#: the two operators, each with one implementation for CPU and CUDA
#: tensors (which picks plain or kernel by device) and a fake one (shapes
#: only); autograd sits above the forward in ``_FlashCausal``
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_causal(Tensor q, Tensor k, Tensor v) -> Tensor")
_LIB.define("flash_attention_causal_bwd(Tensor q, Tensor k, Tensor v, "
            "Tensor out, Tensor dout) -> (Tensor, Tensor, Tensor)")


def _forward_impl(q, k, v):
    """The forward operator's implementation: ``_forward``, looked up at
    each call (so a caller may wrap it)."""
    return _forward(q, k, v)


for _key in ("CPU", "CUDA"):
    _LIB.impl("flash_attention_causal", _forward_impl, _key)


@torch.library.register_fake("repro_torch::flash_attention_causal",
                             lib=_LIB)
def _flash_fake(q, k, v):
    return q.new_empty(q.shape)


class _FlashCausal(torch.autograd.Function):
    """The forward operator with ``flash_attention_causal_bwd`` as its
    gradient (both the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out = torch.ops.repro_torch.flash_attention_causal(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return flash_attention_causal_bwd(q, k, v, out, dout.contiguous())


def flash_attention_causal(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention over one sequence per batch row (see the
    module doc); differentiable in q, k and v."""
    check_attention_inputs("flash_attention_causal", q, k, v, 5)
    b, s, kvh, g, dh = q.shape
    if tuple(k.shape) != (b, s, kvh, dh):
        raise ValueError(f"flash_attention_causal: q {tuple(q.shape)} does "
                         f"not match k {tuple(k.shape)}")
    return _FlashCausal.apply(q, k, v)


def flash_attention_causal_bwd_plain(q, k, v, out, dout, block_q: int = 256):
    """The backward's formula in PyTorch, q block by q block (the CPU path
    and the kernel's oracle): with s = (Dh^-0.5 q) . k in float32 under
    the causal mask, P = exp(s - logsumexp(s)), D = sum(dout * out),
    dS = P (dout . v - D); dv = P^T dout, dk = dS^T (Dh^-0.5 q) and
    dq = Dh^-0.5 dS k, summed over the G heads of a group for dk and dv,
    in float32, returned in q's dtype.

    dout . v and D are each summed in float64 (the products of float32
    values are exact there) and rounded to float32, so where the true dS
    is 0 (S = 1: P = 1 and out = v_0, so dout . v_0 = D) both round to
    the same float32 and dq and dk are exactly 0, not two summation
    orders' rounding noise."""
    b, s, kvh, g, dh = q.shape
    scale = dh ** -0.5
    qf = q.float() * scale
    kf, vf, dof = k.float(), v.float(), dout.float()
    dvec = (dof.double() * out.double()).sum(dim=-1).float()  # [B,S,KvH,G]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, s, block_q):
        q1 = min(s, q0 + block_q)
        sc = torch.einsum("bqhgd,bkhd->bqhgk", qf[:, q0:q1], kf[:, :q1])
        mask = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        sc = torch.where(mask[None, :, None, None], sc, -torch.inf)
        p = torch.exp(sc - torch.logsumexp(sc, dim=-1, keepdim=True))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof[:, q0:q1].double(),
                          vf[:, :q1].double()).float()
        ds = p * (dp - dvec[:, q0:q1, ..., None])
        dv[:, :q1] += torch.einsum("bqhgk,bqhgd->bkhd", p, dof[:, q0:q1])
        dk[:, :q1] += torch.einsum("bqhgk,bqhgd->bkhd", ds, qf[:, q0:q1])
        dq[:, q0:q1] = torch.einsum("bqhgk,bkhd->bqhgd", ds,
                                    kf[:, :q1]) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: the backward's kernels, in launch order
BWD_KERNELS = ("stats", "dkdv", "dq")
#: each route's source under csrc/ and its functions' suffix after the dtype
_BWD_ROUTES = {"wgmma": ("flash_attention_bwd_wgmma", "_wgmma"),
               "tf32x3": ("flash_attention_bwd_tf32x3", "_tf32x3"),
               "cuda_cores": ("flash_attention_bwd", "")}


def flash_attention_causal_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor):
    """(dq, dk, dv) of ``flash_attention_causal`` at (q, k, v), given its
    output ``out`` and the output's gradient ``dout`` (see the module
    doc): the plain version on CPU tensors, else the three kernels of
    the route ``flash_bwd_route`` picks."""
    check_attention_inputs("flash_attention_causal_bwd", q, k, v, 5)
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_causal_bwd: {name} "
                             f"{tuple(x.shape)} {x.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    return torch.ops.repro_torch.flash_attention_causal_bwd(q, k, v, out,
                                                            dout)


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor):
    """The backward call: the plain version on CPU tensors, else the
    route's three kernels."""
    if q.device.type == "cpu":
        return flash_attention_causal_bwd_plain(q, k, v, out, dout)
    b, s, kvh, g, dh = q.shape
    check_kernel_limits("flash_attention_causal_bwd", (q, k, v, out, dout),
                        g, dh, MAX_DH)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if dq.numel() == 0:
        return dq, dk, dv
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    dvec = torch.empty_like(lse)
    shape = [b, s, kvh, g, dh, dh ** -0.5]
    sig = [ctypes.c_int] * 5 + [ctypes.c_float]
    route = flash_bwd_route(q, k, v, out, dout)
    source, route_suffix = _BWD_ROUTES[route]
    suffix = _SUFFIX[q.dtype] + route_suffix
    ptrs = {"stats": [q, k, out, dout, lse, dvec],
            "dkdv": [q, k, v, dout, lse, dvec, dk, dv],
            "dq": [q, k, v, dout, lse, dvec, dq]}
    for kernel in BWD_KERNELS:
        args = ptrs[kernel]
        _build.call(source, f"flash_attention_causal_bwd_{kernel}_{suffix}",
                    [ctypes.c_void_p] * len(args) + sig,
                    [x.data_ptr() for x in args] + shape, q.device)
        count(f"flash_attention_causal_bwd/{kernel}")
    count("flash_attention_causal_bwd",
          f"flash_attention_causal_bwd/{route}")
    return dq, dk, dv


def _backward_impl(q, k, v, out, dout):
    """The backward operator's implementation: ``_backward``, looked up at
    each call (so a caller may wrap it, as the forward's)."""
    return _backward(q, k, v, out, dout)


for _key in ("CPU", "CUDA"):
    _LIB.impl("flash_attention_causal_bwd", _backward_impl, _key)


@torch.library.register_fake("repro_torch::flash_attention_causal_bwd",
                             lib=_LIB)
def _flash_bwd_fake(q, k, v, out, dout):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
