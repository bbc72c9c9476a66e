"""The port's model pieces against the JAX package: the architecture
table, ``param_defs`` (names, shapes, dtypes, init kinds) of every
architecture, reduced and full, ``ServeEngine``'s refusal of the
families it does not serve, ``params_from_reference``, ``init_params``,
and the
numerics of ``rms_norm``, ``apply_rope`` and ``dense_fwd`` on the same
seeded numpy inputs (float32 to 1e-6 / 1e-5: the same arithmetic, summed
in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_
from repro.configs import archs as ref_archs
from repro.models import ffn as ref_ffn
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.configs import archs
from repro_torch.models import ffn, layers, transformer


def test_architecture_table_is_the_references():
    assert sorted(archs.ALL_ARCHS) == sorted(ref_archs.ALL_ARCHS)
    for name, ref in ref_archs.ALL_ARCHS.items():
        assert dataclasses.asdict(archs.get_config(name)) == \
            dataclasses.asdict(ref), name
        assert dataclasses.asdict(archs.reduced_config(name)) == \
            dataclasses.asdict(ref_archs.reduced_config(name)), name
    with pytest.raises(KeyError):
        archs.get_config("nope")


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", sorted(ref_archs.ALL_ARCHS))
def test_param_defs_match_reference(arch, reduced):
    get = "reduced_config" if reduced else "get_config"
    cfg = getattr(archs, get)(arch)
    ref = ref_tf.param_defs(getattr(ref_archs, get)(arch))
    port = transformer.param_defs(cfg)
    assert set(port) == set(ref)
    for name, d in ref.items():
        assert dataclasses.astuple(port[name]) == dataclasses.astuple(d), name
    if not reduced and arch == "smollm-360m":   # shapes only, no allocation
        assert port["layers/attn/wq"].shape == (32, 960, 960)
        assert port["layers/attn/wk"].shape == (32, 960, 320)
        assert port["layers/ffn/w1"].shape == (32, 960, 2560)
        assert port["embed"].shape == (49152, 960)


@pytest.mark.parametrize("name", ["mamba2-370m", "seamless-m4t-large-v2",
                                  "hymba-1.5b", "deepseek-v2-lite-16b",
                                  "grok-1-314b"])
def test_serve_engine_refuses_other_families(name):
    """The models of every family are ported, but ``ServeEngine`` serves
    the dense GQA decoder only (its inline forward has no MoE, MLA, SSM
    or encoder)."""
    from repro_torch.serving import ServeEngine
    cfg = archs.reduced_config(name)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    with pytest.raises(NotImplementedError, match="dense GQA decoder"):
        ServeEngine(cfg, params, device="cpu")


def _reduced(dtype="float32"):
    cfg = dataclasses.replace(archs.reduced_config("smollm-360m"),
                              dtype=dtype)
    ref_cfg = dataclasses.replace(ref_archs.reduced_config("smollm-360m"),
                                  dtype=dtype)
    return cfg, ref_cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference(dtype):
    cfg, ref_cfg = _reduced(dtype)
    ref = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, ref)
    port = transformer.params_from_reference(params_np, cfg, "cpu")
    flat_ref = layers.flatten(params_np)
    flat = layers.flatten(port)
    assert set(flat) == set(flat_ref)
    for name, a in flat_ref.items():
        assert np.array_equal(np_(flat[name].float()),
                              np.asarray(a, np.float32)), name
    assert flat["final_norm"].dtype == torch.float32
    assert flat["embed"].dtype == getattr(torch, dtype)
    lp = transformer.layer_params(port, 1)
    assert torch.equal(lp["attn"]["wq"], port["layers"]["attn"]["wq"][1])
    bad = dict(flat_ref, embed=flat_ref["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        transformer.params_from_reference(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="names"):
        transformer.params_from_reference(
            {k: v for k, v in flat_ref.items() if k != "embed"}, cfg, "cpu")
    wrong = dict(flat_ref, embed=flat_ref["embed"].astype(np.float16))
    with pytest.raises(TypeError, match="embed"):
        transformer.params_from_reference(wrong, cfg, "cpu")


def test_init_params_schema_and_scale():
    cfg, _ = _reduced("bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, "cpu")
    flat = layers.flatten(params)
    defs = transformer.param_defs(cfg)
    assert set(flat) == set(defs)
    for name, d in defs.items():
        assert tuple(flat[name].shape) == d.shape, name
        want = torch.float32 if d.dtype == "float32" else torch.bfloat16
        assert flat[name].dtype == want, name
    assert torch.equal(flat["final_norm"], torch.ones(cfg.d_model))
    std = flat["layers/ffn/w1"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    again = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    assert all(torch.equal(flat[k], v)
               for k, v in layers.flatten(again).items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_parity(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    jd = getattr(jnp, dtype)
    ref = ref_layers.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale), 1e-5)
    port = layers.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(scale), 1e-5)
    assert port.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(np_(port.float()), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_apply_rope_parity():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 37)).astype(np.int32)
    ref = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    port = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10000.0)
    np.testing.assert_allclose(np_(port), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(layers.rope_freqs(16, 1e6),
                          np.asarray(ref_layers.rope_freqs(16, 1e6)))


def test_apply_rope_copies_its_frequencies_once():
    """The frequencies reach the device once per (head_dim, theta,
    device), so a layer loop makes no host-to-device copy."""
    x = torch.ones((1, 3, 2, 16))
    pos = torch.arange(3)[None]
    first = layers._rope_freqs_on(16, 5e5, x.device)
    layers.apply_rope(x, pos, 5e5)
    assert layers._rope_freqs_on(16, 5e5, x.device) is first
    assert first.dtype == torch.float32
    assert np.array_equal(np_(first), layers.rope_freqs(16, 5e5))


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu",
                                        "geglu"])
def test_dense_fwd_parity(activation):
    cfg, ref_cfg = _reduced()
    cfg = dataclasses.replace(cfg, activation=activation)
    ref_cfg = dataclasses.replace(ref_cfg, activation=activation)
    rng = np.random.default_rng(3)
    defs = ffn.dense_defs(cfg)
    assert {k: d.shape for k, d in defs.items()} == \
        {k: d.shape for k, d in ref_ffn.dense_defs(ref_cfg).items()}
    p = {k: rng.standard_normal(d.shape).astype(np.float32) * 0.1
         for k, d in defs.items()}
    x = rng.standard_normal((4, 3, cfg.d_model)).astype(np.float32)
    ref = ref_ffn.dense_fwd({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), ref_cfg)
    port = ffn.dense_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), cfg)
    np.testing.assert_allclose(np_(port), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
