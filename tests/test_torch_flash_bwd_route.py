"""The route of ``flash_attention_causal``'s backward, and the tensor-core
route's rounding, on the CPU.

``flash_bwd_route`` picks the kernels a CUDA call takes from dtype, Dh
and alignment alone (CPU tensors have the same pointers and shapes, so
it is tested here): ``wgmma`` for bf16 with Dh % 16 == 0, ``tf32x3`` for
float32 with Dh % 8 == 0 (its arithmetic is emulated in
``test_torch_flash_bwd_f32_route.py``), else ``cuda_cores``. The wgmma
route rounds P and dS to bf16 before its three products (dV = P^T dO,
dK = dS^T Q, dQ = dS K), roundings the plain backward does not make: ``design_bwd`` builds that arithmetic in PyTorch
(bf16 operands, float32 sums) and it must stay within the card tests'
bf16 tolerance, 1e-2 of each gradient's largest magnitude, of the plain
backward and of ``jax.vjp`` of the reference's blockwise attention, at
small odd shapes with G from 1 to 7 and Dh from 16 to 192 (MLA's, with V
zero past its 128 columns as the model passes it, and Dh 144-176, whose
third 64-column panel the kernels fill with zeros past Dh).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as ref_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (BWD_WGMMA_MAX_DH,
                                                 flash_bwd_route)

# the card tests' and chip_smoke.py's tolerance for the bf16 backward
BWD_TOL_BF16 = 1e-2


def _tensors(shape, dtype=torch.bfloat16):
    b, s, kvh, g, dh = shape
    return [torch.zeros(x, dtype=dtype) for x in
            (shape, (b, s, kvh, dh), (b, s, kvh, dh), shape, shape)]


@pytest.mark.parametrize("dh", [16, 64, 128, 144, 160, 176, 192])
def test_bf16_multiples_of_16_take_wgmma(dh):
    assert dh <= BWD_WGMMA_MAX_DH
    assert flash_bwd_route(*_tensors((1, 8, 2, 3, dh))) == "wgmma"


# float32 with Dh % 8 == 0 (smollm's 64, MLA's 192) takes the 3xTF32
# tensor-core kernels; float32 Dh 36 and bf16 Dh 40 the CUDA cores
ROUTE_OF = {(torch.float32, 64): "tf32x3", (torch.float32, 192): "tf32x3",
            (torch.bfloat16, 40): "cuda_cores",
            (torch.float32, 36): "cuda_cores"}


@pytest.mark.parametrize("dtype,dh", list(ROUTE_OF))
def test_float32_mla_and_odd_dh_take_cuda_cores(dtype, dh):
    assert flash_bwd_route(*_tensors((1, 8, 2, 3, dh), dtype)) == \
        ROUTE_OF[(dtype, dh)]


def _unaligned(which, dtype=torch.bfloat16):
    """Aligned backward inputs but one (q, k, v, out or dout) a view one
    element into its storage."""
    args = _tensors((1, 8, 2, 3, 64), dtype)
    x = args[which]
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    args[which] = buf[1:].view(x.shape)
    assert args[which].is_contiguous()
    assert args[which].data_ptr() % 16 != 0
    return args


@pytest.mark.parametrize("which", range(5))
def test_an_unaligned_tensor_takes_cuda_cores(which):
    """A view 2 bytes into its storage (q, k, v, out or dout) cannot be a
    TMA source."""
    assert flash_bwd_route(*_unaligned(which)) == "cuda_cores"


@pytest.mark.parametrize("which", range(5))
def test_an_unaligned_float32_tensor_takes_cuda_cores(which):
    """Nor a float32 view 4 bytes into its storage: the tf32x3 route's
    TMA maps need 16-byte aligned tensors too."""
    assert flash_bwd_route(*_unaligned(which, torch.float32)) == \
        "cuda_cores"


def design_bwd(q, k, v, out, dout):
    """The wgmma route's arithmetic: S = q . k and dP = dout . v from bf16
    operands in float32, P = exp(Dh^-0.5 S - lse) under the causal mask,
    dS = P (dP - D); P and dS rounded to bf16 before dV = P^T dout,
    dK = Dh^-0.5 dS^T q and dQ = Dh^-0.5 dS k, each summed in float32 and
    returned in bf16."""
    b, s, kvh, g, dh = q.shape
    scale = dh ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    dvec = (dof * out.float()).sum(dim=-1)
    sc = torch.einsum("bqhgd,bkhd->bqhgk", qf, kf) * scale
    mask = torch.arange(s)[None, :] <= torch.arange(s)[:, None]
    sc = torch.where(mask[None, :, None, None], sc, -torch.inf)
    p = torch.exp(sc - torch.logsumexp(sc, dim=-1, keepdim=True))
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vf)
    ds = p * (dp - dvec[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p16, dof)
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds16, qf) * scale
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds16, kf) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _rel_errs(got, want):
    return [float((a.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30))
            for a, w in zip(got, want)]


# (b, s, kvh, g, dh): odd S, G from 1 to 7, Dh from 16 to 192
DESIGN_SHAPES = [(1, 37, 2, 1, 16), (2, 65, 1, 3, 64), (1, 130, 2, 5, 32),
                 (1, 77, 1, 7, 128), (2, 50, 2, 2, 48), (1, 129, 1, 4, 80),
                 (1, 300, 1, 3, 64), (1, 96, 2, 5, 192), (2, 130, 1, 1, 192),
                 (1, 77, 2, 3, 160), (1, 65, 1, 2, 144)]
# shapes whose V is zero from this column on, as MLA's attention pads its
# 128-column V to Dh = 192
V_ZERO_FROM = {(2, 130, 1, 1, 192): 128}


@pytest.mark.parametrize("shape", DESIGN_SHAPES)
def test_design_rounding_within_tolerance(shape):
    """The wgmma route's roundings against the plain backward and against
    jax.vjp of the reference's blockwise attention on the same bf16
    values: within 1e-2 of each gradient's largest magnitude."""
    rng = np.random.default_rng(sum(shape))
    b, s, kvh, g, dh = shape
    q, k, v, dout = (torch.from_numpy(
        rng.standard_normal(x).astype(np.float32)).bfloat16()
        for x in (shape, (b, s, kvh, dh), (b, s, kvh, dh), shape))
    v[..., V_ZERO_FROM.get(shape, dh):] = 0
    out = ops.flash_attention_causal_plain(q, k, v)
    got = design_bwd(q, k, v, out, dout)
    assert max(_rel_errs(got, ops.flash_attention_causal_bwd_plain(
        q, k, v, out, dout))) <= BWD_TOL_BF16

    def ref_fn(q_, k_, v_):
        return ref_flash(q_.reshape(b, s, kvh * g, dh), k_, v_, causal=True,
                         chunk=16)

    _, vjp = jax.vjp(ref_fn, *(jnp.asarray(x.float().numpy())
                               for x in (q, k, v)))
    ref = vjp(jnp.asarray(dout.float().numpy()).reshape(b, s, kvh * g, dh))
    ref = [torch.from_numpy(np.array(r)).reshape(x.shape)
           for r, x in zip(ref, (q, k, v))]
    assert max(_rel_errs(got, ref)) <= BWD_TOL_BF16
