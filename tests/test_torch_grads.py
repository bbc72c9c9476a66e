"""Gradients of the port against the JAX package's, on the CPU.

``loss_fn``'s value and gradient for every architecture of
``configs/archs.py`` (reduced configs, float32) against
``jax.value_and_grad`` of the reference's ``loss_fn``, on
``tests/test_archs.py``'s all-ones batch (MoE's tied router
probabilities) and on a seeded random one; the four remat policies give
one gradient; and the flash kernel's ``autograd.Function`` (on the CPU:
the plain forward, the plain backward) against ``torch.autograd`` through
``flash_attention_causal_plain`` and against ``jax.grad`` of the
reference's blockwise ``flash_attention``. Tolerance: 1e-4 of each leaf's
largest magnitude (the same float32 arithmetic, summed in another
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_
from repro.configs import archs as ref_archs
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models.layers import flash_attention as ref_flash
from repro_torch.configs import archs
from repro_torch.kernels import ops
from repro_torch.models import layers, loss_fn, transformer
from test_archs import _batch as ref_batch
from test_torch_models_families import _port_batch, random_batch

ARCHS = sorted(ref_archs.ALL_ARCHS)
REF_INIT = jax.jit(ref_init_params, static_argnums=0)
REF_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(ref_loss_fn),
                             static_argnums=2)
TOL = 1e-4
B = 2


def _configs(arch, remat="full"):
    return (dataclasses.replace(archs.reduced_config(arch), dtype="float32",
                                remat=remat),
            dataclasses.replace(ref_archs.reduced_config(arch),
                                dtype="float32"))


def port_value_and_grad(params, batch, cfg):
    """(loss, {"a/b": gradient}) of the port's ``loss_fn``; a leaf that
    the loss does not reach gets zeros, as ``jax.grad`` gives it."""
    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in layers.flatten(params).items()}
    loss = loss_fn(layers.unflatten(flat), batch, cfg)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(flat.items(), grads)}


def assert_leaves_close(ref: dict, port: dict, what: str, tol=TOL,
                        floor_share=1e-6):
    """Each leaf within ``tol`` of its largest magnitude. A leaf whose
    gradient is zero but for rounding is measured against ``floor_share``
    of the tree's largest magnitude instead (1e-3 on the all-ones batch:
    every position carries the same key and value, so the gradients of
    ``wq`` / ``wk`` (and MLA's ``w_uk``) vanish analytically and their
    bits, 1e-15 to 1e-5, are rounding noise in both packages)."""
    assert set(ref) == set(port), what
    floor = floor_share * max(np.abs(np.asarray(r)).max()
                              for r in ref.values())
    for name, r in ref.items():
        r, p = np.asarray(r, np.float64), np_(port[name]).astype(np.float64)
        assert p.shape == r.shape, (what, name)
        assert np.isfinite(p).all(), (what, name)
        scale = max(np.abs(r).max(), floor, 1e-30)
        err = np.abs(p - r).max() / scale
        assert err <= tol, f"{what}: {name} differs by {err:.3g} of " \
                           f"its largest magnitude {scale:.3g}"


@pytest.fixture(scope="module")
def models():
    """Per architecture: the reference's float32 parameters and the same
    parameters in the port (built once per module)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, ref_cfg = _configs(arch)
            ref = REF_INIT(ref_cfg, jax.random.PRNGKey(0))
            port = transformer.params_from_reference(
                jax.tree.map(np.asarray, ref), cfg, "cpu")
            cache[arch] = ref, port
        return cache[arch]
    return get


def _flat_ref(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_ref(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("data", ["ones", "random"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_matches_reference(arch, data, models):
    cfg, ref_cfg = _configs(arch)
    ref, port = models(arch)
    batch = (ref_batch(ref_cfg, b=B) if data == "ones"
             else random_batch(ref_cfg))
    ref_loss, ref_grads = REF_VALUE_AND_GRAD(ref, batch, ref_cfg)
    loss, grads = port_value_and_grad(port, _port_batch(batch), cfg)
    np.testing.assert_allclose(np_(loss), np.asarray(ref_loss), rtol=TOL,
                               atol=TOL)
    assert_leaves_close(_flat_ref(ref_grads), grads, f"{arch} {data}",
                        floor_share=1e-3 if data == "ones" else 1e-6)


@pytest.mark.parametrize("remat", ["none", "dots", "save_attn"])
@pytest.mark.parametrize("arch", ["smollm-360m", "seamless-m4t-large-v2",
                                  "hymba-1.5b", "deepseek-v2-lite-16b"])
def test_remat_policies_give_one_gradient(arch, remat, models):
    """Each policy's loss and gradient equal the default ("full")
    policy's, bit for bit: remat changes what the backward keeps, never
    what it computes."""
    _, ref_cfg = _configs(arch)
    _, port = models(arch)
    batch = _port_batch(random_batch(ref_cfg))
    full = port_value_and_grad(port, batch, _configs(arch, "full")[0])
    other = port_value_and_grad(port, batch, _configs(arch, remat)[0])
    assert torch.equal(full[0], other[0])
    for name, g in full[1].items():
        assert torch.equal(g, other[1][name]), (remat, name)


def test_unknown_remat_policy_raises(models):
    cfg = _configs("smollm-360m", "everything")[0]
    _, port = models("smollm-360m")
    batch = _port_batch(random_batch(_configs("smollm-360m")[1]))
    with pytest.raises(ValueError, match="remat"):
        loss_fn(port, batch, cfg)


# the flash kernel's gradient: odd S (no block divides it), G in {1, 3},
# Dh in {16, 192} (MLA's width)
FLASH_SHAPES = [(2, 37, 2, g, dh) for g in (1, 3) for dh in (16, 192)]


def _flash_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, s, kvh, g, dh = shape
    return [rng.standard_normal(x).astype(np.float32)
            for x in ((b, s, kvh, g, dh), (b, s, kvh, dh), (b, s, kvh, dh),
                      (b, s, kvh, g, dh))]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_function_gradient(shape):
    """``flash_attention_causal``'s backward (the plain one, on the CPU)
    against autograd through ``flash_attention_causal_plain`` and against
    ``jax.grad`` of the reference's blockwise ``flash_attention``; no
    kernel launch is counted on the CPU."""
    q, k, v, dout = _flash_inputs(shape, sum(shape))
    b, s, kvh, g, dh = shape
    ops.reset_launches()

    def torch_grads(fn):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = fn(*ts)
        out.backward(torch.from_numpy(dout))
        return out.detach(), [t.grad for t in ts]

    out, grads = torch_grads(ops.flash_attention_causal)
    assert all(n == 0 for n in ops.LAUNCHES.values())
    plain_out, plain_grads = torch_grads(ops.flash_attention_causal_plain)
    assert torch.equal(out, plain_out)

    def ref_fn(q_, k_, v_):
        return ref_flash(q_.reshape(b, s, kvh * g, dh), k_, v_, causal=True,
                         chunk=16)

    ref_out, vjp = jax.vjp(ref_fn, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(dout).reshape(b, s, kvh * g, dh))
    names = ("dq", "dk", "dv")
    assert_leaves_close(dict(zip(names, plain_grads)),
                        dict(zip(names, grads)), "autograd of the plain")
    assert_leaves_close({n: np.asarray(r).reshape(x.shape) for n, r, x in
                         zip(names, ref_grads, (q, k, v))},
                        dict(zip(names, grads)), "jax.grad of the reference")
    np.testing.assert_allclose(np_(out).reshape(ref_out.shape),
                               np.asarray(ref_out), rtol=TOL, atol=TOL)


def test_flash_backward_checks_its_inputs():
    q, k, v, dout = (torch.from_numpy(x) for x in
                     _flash_inputs((1, 5, 1, 2, 8), 0))
    out = ops.flash_attention_causal_plain(q, k, v)
    with pytest.raises(ValueError, match="dout"):
        ops.flash_attention_causal_bwd(q, k, v, out, dout[:, :4])
    with pytest.raises(ValueError, match="out"):
        ops.flash_attention_causal_bwd(q, k, v, out.to(torch.bfloat16), dout)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssd_overflow_gives_the_reference_nan(arch, models):
    """SSD evaluates ``exp`` over a chunk's masked upper triangle
    (``ssm.py``'s ``torch.where(mask, exp(li), 0)``, the reference's
    ``jnp.where``): once a chunk's decay passes ~88 the forward stays
    finite and the gradient turns NaN (inf x 0), in the reference too.
    With A_log = log 8 a 32-step chunk gets there; the port is held to
    the reference's loss and to its NaN pattern, leaf by leaf (ROADMAP.md,
    known limits on the reference side)."""
    cfg, ref_cfg = _configs(arch)
    flat_ref = _flat_ref(models(arch)[0])
    for name in [k for k in flat_ref if k.endswith("ssm/A_log")]:
        flat_ref[name] = jnp.full_like(flat_ref[name], np.log(8.0))
    ref = layers.unflatten(flat_ref)
    port = transformer.params_from_reference(
        {k: np.asarray(v) for k, v in flat_ref.items()}, cfg, "cpu")
    batch = random_batch(ref_cfg)
    ref_loss, ref_grads = REF_VALUE_AND_GRAD(ref, batch, ref_cfg)
    loss, grads = port_value_and_grad(port, _port_batch(batch), cfg)
    np.testing.assert_allclose(np_(loss), np.asarray(ref_loss), rtol=TOL,
                               atol=TOL)
    ref_flat = _flat_ref(ref_grads)
    nan_leaves = []
    for name, r in ref_flat.items():
        r = np.asarray(r)
        finite = np.isfinite(r)
        assert np.array_equal(finite, np.isfinite(np_(grads[name]))), name
        if not finite.all():
            nan_leaves.append(name)
    assert nan_leaves, "the overflow did not show"

