"""Every architecture of ``configs/archs.py`` through the port's model API
against the JAX package's, one case per architecture (reduced configs,
float32): ``param_defs`` and ``num_params``, ``params_from_reference``,
``init_params``, ``abstract_params``, ``init_cache``, and ``loss_fn``,
``prefill``'s last logits and two ``decode_step``s (logits and every
cache leaf), on ``tests/test_archs.py``'s own batch and on a seeded random
one. The reference's batch is all ones, so every position carries the
same x and v, and attention returns v whatever its mask: only the random
batch can tell a wrong causal flag, window or cross-attention. Tolerance
rtol = atol = 1e-4: the same float32 arithmetic, summed in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_
from repro.configs import archs as ref_archs
from repro.models import (decode_step as ref_decode_step,
                          init_cache as ref_init_cache,
                          init_params as ref_init_params,
                          loss_fn as ref_loss_fn, prefill as ref_prefill)
from repro.models import transformer as ref_tf
from repro_torch.configs import archs
from repro_torch.models import (abstract_params, decode_step, init_cache,
                                init_params, layers, loss_fn, param_defs,
                                prefill, transformer)
from test_archs import _batch as ref_batch

ARCHS = sorted(ref_archs.ALL_ARCHS)
# the reference jitted (the config static): its eager op-by-op dispatch
# costs 5-10x the compile at these sizes
REF_INIT = jax.jit(ref_init_params, static_argnums=0)
REF_LOSS = jax.jit(ref_loss_fn, static_argnums=2)
REF_PREFILL = jax.jit(ref_prefill, static_argnums=2)
REF_DECODE = jax.jit(ref_decode_step, static_argnums=3)
TOL = dict(rtol=1e-4, atol=1e-4)
B, MAX_LEN = 2, 32
DECODE_TOKENS = ([[3], [7]], [[11], [5]])


def _configs(arch):
    return (dataclasses.replace(archs.reduced_config(arch), dtype="float32"),
            dataclasses.replace(ref_archs.reduced_config(arch),
                                dtype="float32"))


def _port_batch(batch):
    """The reference's batch as CPU tensors (bf16 stays bf16)."""
    out = {}
    for k, v in batch.items():
        if v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(np.asarray(v, np.float32)).to(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _leaves(tree, prefix=""):
    """{"a/b": leaf} of a nested dict (JAX or torch leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _same_tree(ref, port, what, values=True):
    ref, port = _leaves(ref), _leaves(port)
    assert set(ref) == set(port), what
    for name, r in ref.items():
        p = port[name]
        assert tuple(p.shape) == tuple(r.shape), (what, name)
        assert str(p.dtype).split(".")[-1] == str(r.dtype), (what, name)
        if values:
            np.testing.assert_allclose(np_(p), np.asarray(r), err_msg=(
                f"{what}: {name}"), **TOL)


@pytest.fixture(scope="module")
def models():
    """Per architecture: configs, the reference's float32 parameters and
    the same parameters in the port (built once per module)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, ref_cfg = _configs(arch)
            ref = REF_INIT(ref_cfg, jax.random.PRNGKey(0))
            port = transformer.params_from_reference(
                jax.tree.map(np.asarray, ref), cfg, "cpu")
            cache[arch] = cfg, ref_cfg, ref, port
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_and_params(arch, models):
    """``param_defs`` (full config: shapes only, nothing allocated) and
    ``num_params``, ``params_from_reference``, ``init_params`` and
    ``abstract_params`` against the schema."""
    full = archs.get_config(arch)
    defs = param_defs(full)
    ref_defs = ref_tf.param_defs(ref_archs.get_config(arch))
    assert {k: dataclasses.astuple(d) for k, d in defs.items()} == \
        {k: dataclasses.astuple(d) for k, d in ref_defs.items()}
    assert full.num_params() == ref_archs.get_config(arch).num_params()
    abstract = layers.flatten(abstract_params(full))
    assert set(abstract) == set(defs)
    for name, d in defs.items():
        t = abstract[name]
        assert t.device.type == "meta" and tuple(t.shape) == d.shape, name
        want = d.dtype or full.dtype
        assert t.dtype == getattr(torch, want), name
    ref_abs = ref_tf.abstract_params(ref_archs.get_config(arch))
    _same_tree(ref_abs, abstract_params(full), "abstract_params",
               values=False)

    cfg, _, ref, port = models(arch)
    _same_tree(ref, port, "params_from_reference")
    fresh = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _same_tree(ref, fresh, "init_params", values=False)


def random_batch(cfg, seed: int = 5):
    """``ref_batch``'s keys, shapes and dtypes, drawn with numpy from
    ``seed``: tokens and labels in [1, vocab), patches and frames normal,
    rounded to bf16 as the reference's are."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in ref_batch(cfg, b=B).items():
        if v.dtype == jnp.int32:
            out[k] = jnp.asarray(rng.integers(1, cfg.vocab_size, v.shape),
                                 jnp.int32)
        else:
            out[k] = jnp.asarray(rng.standard_normal(v.shape), v.dtype)
    return out


@pytest.mark.parametrize("data", ["ones", "random"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_prefill_decode_match_reference(arch, data, models):
    cfg, ref_cfg, ref, port = models(arch)
    batch = (ref_batch(ref_cfg, b=B) if data == "ones"
             else random_batch(ref_cfg))
    pb = _port_batch(batch)
    np.testing.assert_allclose(
        np_(loss_fn(port, pb, cfg)),
        np.asarray(REF_LOSS(ref, batch, ref_cfg)), **TOL)

    batch.pop("labels")
    pb.pop("labels")
    ref_logits, ref_none = REF_PREFILL(ref, batch, ref_cfg)
    logits, none = prefill(port, pb, cfg)
    assert ref_none is None and none is None
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(np_(logits), np.asarray(ref_logits), **TOL)

    ref_cache = ref_init_cache(ref_cfg, B, MAX_LEN, jnp.float32)
    cache = init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    _same_tree(ref_cache, cache, "init_cache")
    for i, toks in enumerate(DECODE_TOKENS):
        ref_logits, ref_cache = REF_DECODE(
            ref, ref_cache, jnp.asarray(toks, jnp.int32), ref_cfg)
        logits, cache = decode_step(
            port, cache, torch.tensor(toks, dtype=torch.int32), cfg)
        np.testing.assert_allclose(np_(logits), np.asarray(ref_logits),
                                   err_msg=f"step {i}", **TOL)
        _same_tree(ref_cache, cache, f"cache after step {i}")


def test_decode_matches_prefill_logits(models):
    """As ``test_archs.py::test_decode_matches_prefill_logits``: the last
    prefill logits equal a step-by-step decode over the prompt (float32,
    so to 1e-4 rather than the bf16 test's 0.15)."""
    cfg, _, _, port = models("qwen3-32b")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(1, 100, (1, 8)).astype(np.int32))
    pf_logits, _ = prefill(port, {"tokens": toks}, cfg)
    cache = init_cache(cfg, 1, 16, torch.float32, "cpu")
    for i in range(8):
        logits, cache = decode_step(port, cache, toks[:, i:i + 1], cfg)
    np.testing.assert_allclose(np_(logits), np_(pf_logits), **TOL)
    assert int(cache["layers"]["len"][0]) == 8


def test_init_cache_defaults_to_the_card(monkeypatch):
    cfg, _ = _configs("smollm-360m")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator().manual_seed(0))
