"""The port's MoE FFN and Mamba-2 SSD block against the JAX package on
the same seeded numpy inputs (float32, CPU).

MoE: the cases of ``tests/test_moe.py`` (the capacity-bounded dispatch
equals every token through every expert mixed by the top-k weights when
nothing is dropped; a binding capacity drops, never corrupts; shared
experts), the Switch aux loss, and a batch of identical tokens, whose
router probabilities tie exactly (``jax.lax.top_k`` picks the lower
expert index; so must the port). SSM: ``ssd_chunked`` with and without
an initial state, ``ssm_fwd``, and a chain of ``ssm_decode`` steps
against ``ssm_fwd`` on the same tokens. Tolerance rtol = atol = 1e-4
unless a case says otherwise: the same float32 arithmetic, summed in
another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_
from repro.configs import reduced_config as ref_reduced
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import ffn as ref_ffn
from repro.models import ssm as ref_ssm
from repro_torch.configs import reduced_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import ffn, ssm

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np_(port), np.asarray(ref), **(kw or TOL))


def _moe_cfgs(num_experts=4, top_k=2, capacity_factor=8.0, d=16, f=32,
              num_shared=0, activation="gelu"):
    """``tests/test_moe.py::_setup``'s config, float32, both packages."""
    kw = dict(num_experts=num_experts, top_k=top_k, d_ff_expert=f,
              capacity_factor=capacity_factor, num_shared=num_shared)
    cfg = dataclasses.replace(reduced_config("grok-1-314b"), d_model=d,
                              dtype="float32", activation=activation,
                              moe=MoEConfig(**kw))
    ref_cfg = dataclasses.replace(ref_reduced("grok-1-314b"), d_model=d,
                                  dtype="float32", activation=activation,
                                  moe=RefMoEConfig(**kw))
    return cfg, ref_cfg


def _params(defs, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for name, d in defs.items():
        fan_in = max(1, d.shape[d.scale_axis])
        p[name] = (rng.standard_normal(d.shape) * fan_in ** -0.5).astype(
            np.float32)
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: _t(a) for k, a in p.items()})


def _dense_mixture(p, x, cfg):
    """``tests/test_moe.py::_dense_reference`` in numpy terms via torch:
    every token through every expert, combined by the top-k weights."""
    mo = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ p["router"], dim=-1)
    top_w, top_i = ffn.top_k(probs, mo.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    h = torch.einsum("td,edf->tef", xt, p["w1"])
    g = torch.einsum("td,edf->tef", xt, p["w3"])
    eo = torch.einsum("tef,efd->ted", ffn._gate(h, g, cfg), p["w2"])
    w_full = torch.zeros(xt.shape[0], mo.num_experts).scatter_add_(
        1, top_i, top_w)
    return torch.einsum("te,ted->td", w_full, eo).reshape(x.shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
def test_moe_matches_reference_and_dense_mixture(seed, activation):
    """Capacity never binds: the port equals the reference's ``moe_fwd``
    (output and aux loss) and the all-experts mixture (2e-4, as
    test_moe.py: the mixture sums in another order)."""
    cfg, ref_cfg = _moe_cfgs(activation=activation)
    p_j, p_t = _params(ffn.moe_defs(cfg), seed)
    x = np.random.default_rng(seed + 10).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    ref_out, ref_aux = ref_ffn.moe_fwd(p_j, jnp.asarray(x), ref_cfg)
    out, aux = ffn.moe_fwd(p_t, _t(x), cfg)
    _close(out, ref_out)
    _close(aux, ref_aux)
    assert float(aux) > 0
    _close(out, np_(_dense_mixture(p_t, _t(x), cfg)), rtol=2e-4, atol=2e-4)


def test_moe_capacity_drop_matches_reference():
    """capacity_factor 0.25 forces drops: the port drops the same tokens
    (its output equals the reference's), finite, no larger than the
    undropped mixture's norm x 1.5 (test_moe.py's bound)."""
    cfg, ref_cfg = _moe_cfgs(capacity_factor=0.25)
    p_j, p_t = _params(ffn.moe_defs(cfg), 3)
    x = np.random.default_rng(4).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    assert ffn.moe_capacity(cfg.moe, 64) == \
        ref_ffn.moe_capacity(ref_cfg.moe, 64) == 8
    ref_out, _ = ref_ffn.moe_fwd(p_j, jnp.asarray(x), ref_cfg)
    out, _ = ffn.moe_fwd(p_t, _t(x), cfg)
    _close(out, ref_out)
    assert torch.isfinite(out).all()
    dense = _dense_mixture(p_t, _t(x), cfg)
    assert float(out.norm()) <= float(dense.norm()) * 1.5
    assert not torch.allclose(out, dense, atol=1e-3)     # drops happened


def test_moe_shared_experts_match_reference():
    cfg, ref_cfg = _moe_cfgs(num_experts=8, top_k=3, num_shared=2,
                             activation="swiglu")
    defs = ffn.moe_defs(cfg)
    assert {"shared_w1", "shared_w2", "shared_w3"} <= set(defs)
    p_j, p_t = _params(defs, 5)
    x = np.random.default_rng(6).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    ref_out, ref_aux = ref_ffn.moe_fwd(p_j, jnp.asarray(x), ref_cfg)
    out, aux = ffn.moe_fwd(p_t, _t(x), cfg)
    _close(out, ref_out)
    _close(aux, ref_aux)


def test_moe_tied_router_picks_lower_experts():
    """Identical tokens under a router whose columns repeat: every
    token's probabilities tie across experts, so the top-k must be the
    lower indices (``jax.lax.top_k``), and a binding capacity then drops
    the same tokens in both packages."""
    cfg, ref_cfg = _moe_cfgs(num_experts=4, top_k=2, capacity_factor=1.0)
    p_j, p_t = _params(ffn.moe_defs(cfg), 7)
    router = np.repeat(np.asarray(p_j["router"])[:, :1], 4, axis=1)
    p_j = dict(p_j, router=jnp.asarray(router))
    p_t = dict(p_t, router=_t(router))
    x = np.repeat(np.random.default_rng(8).standard_normal(
        (1, 1, cfg.d_model)).astype(np.float32), 12, axis=1)
    probs = torch.softmax(_t(x[0]) @ p_t["router"], dim=-1)
    _, idx = ffn.top_k(probs, 2)
    _, ref_idx = jax.lax.top_k(jnp.asarray(np_(probs)), 2)
    assert np.array_equal(np_(idx), np.asarray(ref_idx))
    assert (np_(idx) == [0, 1]).all()
    ref_out, ref_aux = ref_ffn.moe_fwd(p_j, jnp.asarray(x), ref_cfg)
    out, aux = ffn.moe_fwd(p_t, _t(x), cfg)
    _close(out, ref_out)
    _close(aux, ref_aux)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------
def _ssm_cfgs(arch="mamba2-370m"):
    return (dataclasses.replace(reduced_config(arch), dtype="float32"),
            dataclasses.replace(ref_reduced(arch), dtype="float32"))


def _ssm_params(cfg, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for name, d in ssm.ssm_defs(cfg).items():
        a = rng.standard_normal(d.shape).astype(np.float32)
        if name in ("A_log", "dt_bias"):
            a = 0.5 * a                     # moderate decays and steps
        elif name in ("D", "norm"):
            a = 1 + 0.1 * a
        else:
            a = a * max(1, d.shape[d.scale_axis]) ** -0.5
        p[name] = a
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: _t(a) for k, a in p.items()})


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    rng = np.random.default_rng(20 + with_state)
    b, s, nh, hd, ds, chunk = 2, 96, 4, 8, 16, 32
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(
        np.float32)
    A = -np.exp(0.5 * rng.standard_normal(nh)).astype(np.float32)
    B = rng.standard_normal((b, s, 1, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, 1, ds)).astype(np.float32)
    init = rng.standard_normal((b, nh, hd, ds)).astype(np.float32) \
        if with_state else None
    ref_y, ref_final = ref_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk,
        init_state=None if init is None else jnp.asarray(init))
    y, final = ssm.ssd_chunked(*(_t(a) for a in (x, dt, A, B, C)), chunk,
                               init_state=None if init is None else _t(init))
    _close(y, ref_y)
    _close(final, ref_final)
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(*(_t(a[:, :50]) if a.ndim > 1 else _t(a)
                          for a in (x, dt, A, B, C)), chunk)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_fwd_and_decode_chain_match_reference(arch):
    """``ssm_fwd`` against the reference; then ``ssm_decode`` token by
    token from an empty cache against the reference's steps and against
    the port's own ``ssm_fwd`` on the same tokens (the recurrence and the
    dual form compute one function)."""
    cfg, ref_cfg = _ssm_cfgs(arch)
    p_j, p_t = _ssm_params(cfg, 30)
    s = 2 * cfg.ssm.chunk_size
    x = np.random.default_rng(31).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    ref_y = ref_ssm.ssm_fwd(p_j, jnp.asarray(x), ref_cfg)
    y = ssm.ssm_fwd(p_t, _t(x), cfg)
    _close(y, ref_y)

    cache = ssm.ssm_init_cache(cfg, 2, torch.float32, "cpu")
    ref_cache = ref_ssm.ssm_init_cache(ref_cfg, 2, jnp.float32)
    steps = []
    for i in range(s):
        out, cache = ssm.ssm_decode(p_t, _t(x[:, i:i + 1]), cfg, cache)
        if i < 6:        # the reference's steps, eagerly, a few
            ref_out, ref_cache = ref_ssm.ssm_decode(
                p_j, jnp.asarray(x[:, i:i + 1]), ref_cfg, ref_cache)
            _close(out, ref_out, err_msg=f"step {i}", **TOL)
            for key in ("conv", "state"):
                _close(cache[key], ref_cache[key], err_msg=f"{i} {key}",
                       **TOL)
        steps.append(out)
    _close(torch.cat(steps, dim=1), np_(y))
