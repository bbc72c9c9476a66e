"""The arithmetic of ``flash_attention_causal``'s float32 tensor-core route
(``tf32x3``, ``csrc/flash_attention.cu``), on the CPU.

The tensor cores multiply tf32 operands (10 mantissa bits), so the kernel
takes every product a.b as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, with
x_hi = tf32(x) and x_lo = tf32(x - x_hi) (``cvt.rna.tf32.f32``: to
nearest, ties away from zero), and sums in float32: S = Q.K^T with Q
scaled by Dh^-0.5 log2(e) first, an online softmax in the log2 domain over
key tiles of 64 (Dh <= 64) or 32 keys, O = P.V with P split the same
way. ``design_fwd_tf32x3`` builds that arithmetic in PyTorch (the products
of two tf32 values are exact in float32, so only the summation order
differs from the card's) and it must stay within float32's 1e-5 of the
plain version at small odd shapes (S 1-130, G 1-7, Dh 8-192, MLA's 192
with V zero past its 128 columns) and of the reference's Pallas kernel in
interpret mode where S fits its blocks. One shape shows that a single
tf32 product (``design_fwd_tf32x3(..., products=1)``) misses 1e-5: the
reason for three. The last tests hold what ``chip_smoke.py`` phase 3
measures the card's float32 flash against: the route each case must take
and the float64 softmax.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import \
    flash_attention_causal as ref_pallas
from repro_torch.kernels.flash_attention import (flash_attention_causal_plain,
                                                 flash_route)

TOL = 1e-5          # the float32 tolerance of the card tests and the smoke
LOG2E = 1.4426950408889634


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: half a tf32 ulp added to the magnitude, the
    low 13 mantissa bits cleared (the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, products):
    """einsum ``eq`` of a and b from tf32 operands, summed in float32: the
    three-product split, or one product of the rounded operands."""
    if products == 1:
        return torch.einsum(eq, to_tf32(a), to_tf32(b))
    a_hi, b_hi = to_tf32(a), to_tf32(b)
    a_lo, b_lo = to_tf32(a - a_hi), to_tf32(b - b_hi)
    return (torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_lo, b_hi))


def kernel_tile(dh: int) -> int:
    """Keys a K/V tile of the kernel: 64 at NP <= 2 panels of 32
    columns, 32 above (shared memory)."""
    return 64 if dh <= 64 else 32


def design_fwd_tf32x3(q, k, v, products: int = 3):
    """The tf32x3 kernel's arithmetic on float32 [B, S, KvH, G, Dh] q and
    [B, S, KvH, Dh] k, v (see the module doc)."""
    b, s, kvh, g, dh = q.shape
    scale_log2 = (torch.tensor(dh ** -0.5, dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    qs = q.float() * scale_log2
    kf, vf = k.float(), v.float()
    m = torch.full((b, s, kvh, g), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    pos = torch.arange(s)
    kt = kernel_tile(dh)
    for k0 in range(0, s, kt):
        k1 = min(s, k0 + kt)
        sc = _product("bqhgd,bkhd->bqhgk", qs, kf[:, k0:k1], products)
        mask = torch.arange(k0, k1)[None, :] <= pos[:, None]
        sc = torch.where(mask[None, :, None, None], sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp2(sc - m_safe[..., None])
        corr = torch.where(torch.isfinite(m), torch.exp2(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _product(
            "bqhgk,bkhd->bqhgd", p, vf[:, k0:k1], products)
        m = m_new
    return acc / l.clamp(min=1e-30)[..., None]


def _inputs(shape, seed, mla=False):
    """float32 q, k, v from numpy; ``mla``: v zero past column 128, as
    deepseek-v2-lite's MLA pads v to q's 192 columns."""
    rng = np.random.default_rng(seed)
    b, s, kvh, g, dh = shape
    arrays = [rng.standard_normal(x).astype(np.float32)
              for x in (shape, (b, s, kvh, dh), (b, s, kvh, dh))]
    if mla:
        arrays[2][..., 128:] = 0.0
    return arrays


# (b, s, kvh, g, dh, mla): S 1, 37, 77, 130; G 1-7; Dh 8-192
PLAIN_SHAPES = [(1, 1, 2, 3, 64, False), (2, 37, 1, 7, 8, False),
                (1, 77, 2, 4, 40, False), (1, 130, 2, 1, 192, True),
                (2, 37, 3, 2, 128, False), (1, 77, 1, 5, 96, False),
                (1, 130, 2, 6, 16, False), (1, 77, 2, 1, 184, False),
                (1, 130, 1, 3, 32, False), (1, 37, 2, 2, 192, False)]


@pytest.mark.parametrize("b,s,kvh,g,dh,mla", PLAIN_SHAPES)
def test_tf32x3_design_matches_plain(b, s, kvh, g, dh, mla):
    shape = (b, s, kvh, g, dh)
    q, k, v = (torch.from_numpy(x) for x in _inputs(shape, s + dh, mla))
    assert flash_route(q, k, v) == "tf32x3"
    got = design_fwd_tf32x3(q, k, v)
    want = flash_attention_causal_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,s,kvh,g,dh,mla", [
    (1, 37, 2, 3, 64, False), (1, 77, 2, 1, 192, True),
    (2, 130, 1, 4, 32, False)])
def test_tf32x3_design_matches_pallas(b, s, kvh, g, dh, mla):
    """S <= 256 is one block of the Pallas kernel's, so it takes these."""
    shape = (b, s, kvh, g, dh)
    arrays = _inputs(shape, 7 * s + dh, mla)
    ref = np.asarray(ref_pallas(*(jnp.asarray(x) for x in arrays)))
    got = design_fwd_tf32x3(*(torch.from_numpy(x) for x in arrays))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_one_tf32_product_misses_the_float32_tolerance():
    """At (1, 128, 2, 3, 64) one tf32 product a matrix product misses
    1e-5 of the plain version by orders of magnitude, where three hold
    it: why the route takes three."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 128, 2, 3, 64), 1))
    want = flash_attention_causal_plain(q, k, v)
    one = (design_fwd_tf32x3(q, k, v, products=1) - want).abs().max()
    three = (design_fwd_tf32x3(q, k, v) - want).abs().max()
    assert one > 10 * TOL
    assert three <= TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    """``to_tf32`` rounds as ``cvt.rna.tf32.f32``: 1 + 2^-11 (a tie) goes
    up, 1 + 2^-11 - 2^-23 down, -(1 + 2^-11) away from zero, and the
    split's parts add back to x within 2^-22 |x|."""
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
                      -(1 + 2 ** -11)], dtype=torch.float32)
    assert to_tf32(x).tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -10)]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi = to_tf32(y)
    lo = to_tf32(y - hi)
    assert ((y - hi - lo).abs() <= 2.0 ** -22 * y.abs()).all()


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.float32, 36),
                                      (torch.bfloat16, 192),
                                      (torch.bfloat16, 40)])
def test_smoke_expects_the_wrappers_route(dtype, dh):
    """``chip_smoke.py`` phase 3 fails a case that launched another route
    than the one its dtype and Dh pick (``flash_route_wanted``); for
    aligned tensors that is the wrapper's own choice."""
    import chip_smoke
    q = torch.zeros((1, 8, 1, 2, dh), dtype=dtype)
    k = torch.zeros((1, 8, 1, dh), dtype=dtype)
    assert chip_smoke.flash_route_wanted(dtype, dh) == flash_route(q, k, k)


def test_smoke_float64_yardstick_matches_plain():
    """The float64 softmax against which ``chip_smoke.py`` measures every
    float32 flash output agrees with the plain version within float32's
    1e-5, at a ragged S over more than one of its q blocks."""
    import chip_smoke
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 300, 2, 3, 40), 5))
    exact = chip_smoke.attention_f64(q, k, v)
    assert exact.dtype == torch.float64
    torch.testing.assert_close(flash_attention_causal_plain(q, k, v),
                               exact.float(), rtol=TOL, atol=TOL)
