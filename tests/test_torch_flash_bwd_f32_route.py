"""The arithmetic of ``flash_attention_causal``'s float32 tensor-core
backward (``tf32x3``, ``csrc/flash_attention_bwd_tf32x3.cu``), on the CPU.

The tensor cores multiply tf32 operands (10 mantissa bits), so the three
kernels take every product a.b as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, with
x_hi = tf32(x) and x_lo = tf32(x - x_hi) (``cvt.rna.tf32.f32``), summed in
float32: S = Q.K^T (Q unscaled; Dh^-0.5 log2(e) applied to S in float32),
lse in the log2 domain over 64-key tiles, D = the diagonal of dO.O^T and
dP = dO.V^T summed alike (above Dh = 64 per half of Dh, one half a block
of a cluster, then added), P = exp2(S' - lse), dS = P (dP - D), and dV =
P^T dO, dK = Dh^-0.5 dS^T Q, dQ = Dh^-0.5 dS K with P and dS split the same
way. ``design_bwd_tf32x3`` builds that arithmetic in PyTorch (a product of
two tf32 values is exact in float32, so only the summation order differs
from the card's) and it must stay within the card tests' float32
tolerance, 2e-5 of each gradient's largest magnitude, of the plain
backward and of ``jax.vjp`` of the reference's blockwise attention, at
small odd shapes (S 1-130, G 1-7, Dh 8-192, MLA's 192 with V zero past
its 128 columns). One shape shows that a single tf32 product
(``products=1``) misses 2e-5: the reason for three.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import (
    flash_attention_causal_bwd_plain, flash_attention_causal_plain,
    flash_bwd_route)
from test_torch_flash_f32_route import LOG2E, _product

BWD_TOL = 2e-5      # the card tests' and chip_smoke.py's float32 tolerance


def _halved(eq, a, b, dh, products):
    """``_product`` over Dh (the last axis of both) in the kernels'
    halves, added in float32: one block up to Dh = 64, else a cluster of
    two, each 2 (Dh <= 128) or 3 panels of 32 columns."""
    if dh <= 64:
        return _product(eq, a, b, products)
    cut = 32 * (2 if dh <= 128 else 3)
    return (_product(eq, a[..., :cut], b[..., :cut], products)
            + _product(eq, a[..., cut:], b[..., cut:], products))


def design_bwd_tf32x3(q, k, v, out, dout, products: int = 3):
    """The tf32x3 kernels' arithmetic on float32 [B, S, KvH, G, Dh] q,
    out, dout and [B, S, KvH, Dh] k, v (see the module doc)."""
    b, s, kvh, g, dh = q.shape
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, out, dout))
    pos = torch.arange(s)
    # stats: lse (log2 domain) online over 64-key tiles of the full Dh
    m = torch.full((b, s, kvh, g), -torch.inf)
    l = torch.zeros_like(m)
    for k0 in range(0, s, 64):
        k1 = min(s, k0 + 64)
        sc = _product("bqhgd,bkhd->bqhgk", qf, kf[:, k0:k1],
                      products) * scale_log2
        mask = torch.arange(k0, k1)[None, :] <= pos[:, None]
        sc = torch.where(mask[None, :, None, None], sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp2(m - m_safe), 0.0)
        l = l * corr + torch.exp2(sc - m_safe[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log2(l)
    # D and dP summed alike: per half, then added
    dvec = _halved("bqhgd,bqhgd->bqhg", dof, of, dh, products)
    sc = _halved("bqhgd,bkhd->bqhgk", qf, kf, dh, products) * scale_log2
    dp = _halved("bqhgd,bkhd->bqhgk", dof, vf, dh, products)
    mask = (torch.arange(s)[None, :] <= pos[:, None])[None, :, None, None]
    p = torch.where(mask, torch.exp2(sc - lse[..., None]), 0.0)
    ds = p * (dp - dvec[..., None])
    dv = _product("bqhgk,bqhgd->bkhd", p, dof, products)
    dk = _product("bqhgk,bqhgd->bkhd", ds, qf, products) * scale
    dq = _product("bqhgk,bkhd->bqhgd", ds, kf, products) * scale
    return dq, dk, dv


def _rel_errs(got, want):
    return [float((a.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30))
            for a, w in zip(got, want)]


def _inputs(shape, seed, mla=False):
    """float32 q, k, v, dout and the plain forward's out; ``mla``: v zero
    past column 128, as deepseek-v2-lite's MLA pads v to q's 192."""
    rng = np.random.default_rng(seed)
    b, s, kvh, g, dh = shape
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(x).astype(
        np.float32)) for x in (shape, (b, s, kvh, dh), (b, s, kvh, dh), shape))
    if mla:
        v[..., 128:] = 0.0
    return q, k, v, flash_attention_causal_plain(q, k, v), dout


# (b, s, kvh, g, dh, mla): S 1-130, G 1-7, Dh 8-192 (one block, and the
# cluster's 2 + 2 and 3 + 3 panels, with a panel wholly past Dh at 72
# and 136)
PLAIN_SHAPES = [(1, 1, 1, 1, 16, False), (1, 1, 2, 3, 192, False),
                (2, 37, 1, 7, 8, False), (1, 77, 2, 4, 40, False),
                (1, 130, 2, 1, 192, True), (2, 37, 3, 2, 128, False),
                (1, 77, 1, 5, 96, False), (1, 130, 2, 6, 16, False),
                (1, 65, 2, 3, 72, False), (1, 50, 1, 2, 136, False),
                (1, 130, 1, 3, 64, False), (1, 96, 2, 5, 184, False)]


@pytest.mark.parametrize("b,s,kvh,g,dh,mla", PLAIN_SHAPES)
def test_tf32x3_bwd_design_matches_plain(b, s, kvh, g, dh, mla):
    shape = (b, s, kvh, g, dh)
    args = _inputs(shape, s + dh + g, mla)
    assert flash_bwd_route(*args) == "tf32x3"
    got = design_bwd_tf32x3(*args)
    want = flash_attention_causal_bwd_plain(*args)
    assert max(_rel_errs(got, want)) <= BWD_TOL


@pytest.mark.parametrize("b,s,kvh,g,dh,mla", [
    (1, 37, 2, 3, 64, False), (1, 77, 2, 1, 192, True),
    (2, 50, 1, 4, 32, False)])
def test_tf32x3_bwd_design_matches_jax_vjp(b, s, kvh, g, dh, mla):
    """Against jax.vjp of the reference's blockwise attention on the same
    float32 values (the reference has no Pallas backward)."""
    shape = (b, s, kvh, g, dh)
    q, k, v, out, dout = _inputs(shape, 3 * s + dh, mla)
    got = design_bwd_tf32x3(q, k, v, out, dout)

    def ref_fn(q_, k_, v_):
        return ref_flash(q_.reshape(b, s, kvh * g, dh), k_, v_, causal=True,
                         chunk=16)

    _, vjp = jax.vjp(ref_fn, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    ref = vjp(jnp.asarray(dout.numpy()).reshape(b, s, kvh * g, dh))
    ref = [torch.from_numpy(np.array(r)).reshape(x.shape)
           for r, x in zip(ref, (q, k, v))]
    assert max(_rel_errs(got, ref)) <= BWD_TOL


def test_one_tf32_product_misses_the_float32_tolerance():
    """At (1, 128, 2, 3, 64) one tf32 product a matrix product misses 2e-5
    of the plain backward by an order of magnitude, where three hold it:
    why the route takes three."""
    args = _inputs((1, 128, 2, 3, 64), 1)
    want = flash_attention_causal_bwd_plain(*args)
    one = max(_rel_errs(design_bwd_tf32x3(*args, products=1), want))
    three = max(_rel_errs(design_bwd_tf32x3(*args), want))
    assert one > 10 * BWD_TOL
    assert three <= BWD_TOL


@pytest.mark.parametrize("dh", [16, 128, 192])
def test_s1_gives_exact_zero_dq_dk(dh):
    """At S = 1 out is v_0, and D is summed as dP is (the same terms in the
    same order, per half alike), so dP - D, dS, dq and dk are exactly 0,
    as the plain backward's are."""
    args = _inputs((1, 1, 2, 3, dh), dh)
    assert torch.equal(args[3], args[2][:, :, :, None].expand_as(args[3]))
    dq, dk, _ = design_bwd_tf32x3(*args)
    want = flash_attention_causal_bwd_plain(*args)
    assert not dq.any() and not dk.any()
    assert not want[0].any() and not want[1].any()


@pytest.mark.parametrize("dtype,dh,aligned", [
    (torch.float32, 64, True), (torch.float32, 192, True),
    (torch.float32, 36, True), (torch.float32, 64, False),
    (torch.bfloat16, 192, True), (torch.bfloat16, 40, True)])
def test_smoke_expects_the_wrappers_bwd_route(dtype, dh, aligned):
    """``chip_smoke.py`` phase 3 fails a backward case that launched
    another route than the one its dtype, Dh and alignment pick
    (``bwd_route_wanted``): the wrapper's own choice."""
    import chip_smoke
    args = [x.to(dtype) for x in _inputs((1, 8, 1, 2, dh), dh)]
    if not aligned:
        buf = torch.zeros(args[0].numel() + 1, dtype=dtype)
        args[0] = buf[1:].view(args[0].shape).copy_(args[0])
    assert chip_smoke.bwd_route_wanted(dtype, dh, aligned) == \
        flash_bwd_route(*args)


def test_smoke_requires_tf32x3_backward_in_the_float32_replay():
    """Phase 15's float32 gradient replay accepts exactly one backward
    call a causal layer, all on tf32x3, and refuses one on the CUDA
    cores or a missing call."""
    import chip_smoke
    ok = {"flash_attention_causal_bwd": 2,
          "flash_attention_causal_bwd/tf32x3": 2}
    assert chip_smoke.f32_flash_bwd_routes("x", ok, 2) == {
        "wgmma": 0, "tf32x3": 2, "cuda_cores": 0}
    for bad, n in (({"flash_attention_causal_bwd": 2,
                     "flash_attention_causal_bwd/tf32x3": 1,
                     "flash_attention_causal_bwd/cuda_cores": 1}, 2),
                   (ok, 3)):
        with pytest.raises(AssertionError):
            chip_smoke.f32_flash_bwd_routes("x", bad, n)
