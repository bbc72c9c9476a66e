"""The port's attention layers against the JAX package on the same seeded
numpy inputs (float32, CPU): ``layers.flash_attention`` on both of the
reference's branches (band-skipping causal blocks, the scan over every
chunk) with windows, ``q_offset`` and padding; ``attention_decode`` with
a scalar or [B] ``kv_len`` and a window; GQA (qk-norm, cross-attention
``kv_override``, the global and the ring decode caches, decode against
encoder KV); MLA's forward, compressed cache and absorbed decode.
Tolerance rtol = atol = 1e-4: the same float32 arithmetic, summed in
another order. Also the port's form of
``tests/test_kernels.py::test_flash_kernel_matches_model_path``: the
kernel's plain version equals the model's blockwise attention.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_
from repro.configs import archs as ref_archs
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.configs import archs
from repro_torch.kernels import ops
from repro_torch.models import attention, layers

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np_(port), np.asarray(ref), **(kw or TOL))


def _qkv(seed, b, sq, sk, h, kvh, dh):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, sq, h, dh), _rand(rng, b, sk, kvh, dh),
            _rand(rng, b, sk, kvh, dh))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk,chunk,causal,window,q_offset", [
    (64, 64, 16, True, 0, 0),        # band-skipping causal blocks
    (64, 64, 16, True, 20, 0),       # ... with a window's left edge
    (64, 64, 16, True, 16, 0),       # ... a window of exactly one chunk
    (50, 50, 16, True, 0, 0),        # Sq not a multiple: scan + padding
    (40, 40, 16, True, 9, 0),        # scan with a window
    (24, 56, 16, True, 0, 32),       # chunked prefill: q_offset > 0
    (24, 56, 16, True, 12, 32),      # q_offset and a window
    (48, 37, 16, False, 0, 0),       # non-causal (encoder / cross), padded
    (32, 32, 64, True, 0, 0),        # one chunk: the scan path
])
def test_flash_attention_matches_reference(sq, sk, chunk, causal, window,
                                           q_offset):
    b, h, kvh, dh = 2, 4, 2, 16
    q, k, v = _qkv(sq * 7 + sk + window, b, sq, sk, h, kvh, dh)
    ref = ref_layers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        chunk=chunk, window=window, q_offset=q_offset)
    before = dict(layers.BLOCKWISE)
    port = layers.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  chunk=chunk, window=window,
                                  q_offset=q_offset)
    assert layers.BLOCKWISE["flash"] == before["flash"] + 1
    assert port.dtype == torch.float32 and tuple(port.shape) == q.shape
    _close(port, ref)


@pytest.mark.parametrize("kv_len", ["scalar", "vector"])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_decode_matches_reference(kv_len, window):
    rng = np.random.default_rng(11 + window)
    b, t, h, kvh, dh = 3, 40, 6, 2, 16
    q, k, v = _rand(rng, b, 1, h, dh), _rand(rng, b, t, kvh, dh), \
        _rand(rng, b, t, kvh, dh)
    kl = np.int32(23) if kv_len == "scalar" else \
        np.array([7, 40, 19], np.int32)
    ref = ref_layers.attention_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(kl),
                                      window=window)
    port = layers.attention_decode(_t(q), _t(k), _t(v), _t(kl),
                                   window=window)
    _close(port, ref)
    if kv_len == "scalar":       # a Python int is the same scalar
        again = layers.attention_decode(_t(q), _t(k), _t(v), 23,
                                        window=window)
        assert torch.equal(again, port)


def test_flash_kernel_plain_matches_model_path():
    """``kernels.flash_attention_causal_plain`` (the kernel's oracle)
    equals the port's blockwise ``layers.flash_attention`` — as
    ``tests/test_kernels.py:128-141`` holds the Pallas kernel to the
    reference's — also at MLA's G = 1 with Dh = 1.5 x 128 scaled down."""
    for b, s, kvh, g, dh in ((2, 256, 2, 2, 32), (1, 128, 4, 1, 48)):
        q, k, v = _qkv(s + dh, b, s, s, kvh * g, kvh, dh)
        model = layers.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                       chunk=64)
        plain = ops.flash_attention_causal_plain(
            _t(q).reshape(b, s, kvh, g, dh), _t(k), _t(v))
        _close(plain.reshape(b, s, -1, dh), np_(model))


def test_routes_on_cpu_are_blockwise():
    """On CPU tensors neither function reaches a kernel wrapper."""
    q, k, v = _qkv(0, 1, 8, 8, 2, 1, 8)
    layers.reset_blockwise()
    launches = dict(ops.LAUNCHES)
    layers.flash_attention(_t(q), _t(k), _t(v), causal=True, chunk=4)
    layers.attention_decode(_t(q[:, :1]), _t(k), _t(v), 3)
    assert layers.BLOCKWISE == {"flash": 1, "decode": 1}
    assert ops.LAUNCHES == launches


# ---------------------------------------------------------------------------
# GQA and MLA modules
# ---------------------------------------------------------------------------
def _cfgs(arch, **kw):
    return (dataclasses.replace(archs.reduced_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(ref_archs.reduced_config(arch),
                                dtype="float32", **kw))


def _params(defs, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    p = {}
    for name, d in defs.items():
        if d.init == "ones":       # norms: ones, perturbed
            p[name] = (1 + 0.1 * rng.standard_normal(d.shape)).astype(
                np.float32)
        else:
            p[name] = _rand(rng, *d.shape, scale=scale)
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: _t(a) for k, a in p.items()})


@pytest.mark.parametrize("qk_norm", [False, True])
def test_gqa_fwd_matches_reference(qk_norm):
    cfg, ref_cfg = _cfgs("qwen3-32b", qk_norm=qk_norm, attn_chunk=16)
    p_j, p_t = _params(attention.gqa_defs(cfg), 1)
    x = _rand(np.random.default_rng(2), 2, 48, cfg.d_model)
    ref_out, (ref_k, ref_v) = ref_attn.gqa_fwd(p_j, jnp.asarray(x), ref_cfg)
    out, (k, v) = attention.gqa_fwd(p_t, _t(x), cfg)
    _close(out, ref_out)
    _close(k, ref_k)
    _close(v, ref_v)


def test_gqa_fwd_kv_override_matches_reference():
    """Cross-attention: KV from the encoder, non-causal, no rope."""
    cfg, ref_cfg = _cfgs("seamless-m4t-large-v2", attn_chunk=16)
    p_j, p_t = _params(attention.gqa_defs(cfg), 3)
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 24, cfg.d_model)
    enc_k = _rand(rng, 2, 40, cfg.num_kv_heads, cfg.head_dim)
    enc_v = _rand(rng, 2, 40, cfg.num_kv_heads, cfg.head_dim)
    ref_out, _ = ref_attn.gqa_fwd(p_j, jnp.asarray(x), ref_cfg,
                                  kv_override=(jnp.asarray(enc_k),
                                               jnp.asarray(enc_v)),
                                  rope=False)
    out, _ = attention.gqa_fwd(p_t, _t(x), cfg,
                               kv_override=(_t(enc_k), _t(enc_v)),
                               rope=False)
    _close(out, ref_out)


@pytest.mark.parametrize("window,steps", [(0, 5), (8, 13)])
def test_gqa_decode_matches_reference(window, steps):
    """A global cache of 4 slots written past its end (the clamped last
    slot, as ``dynamic_update_slice``) and a ring of 8 wrapped past t."""
    cfg, ref_cfg = _cfgs("hymba-1.5b")
    p_j, p_t = _params(attention.gqa_defs(cfg), 5)
    t = window or 4
    shape = (2, t, cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(6)
    ref_c = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
             "len": jnp.zeros((), jnp.int32)}
    c = {"k": torch.zeros(shape), "v": torch.zeros(shape),
         "len": torch.zeros((), dtype=torch.int32)}
    for i in range(steps):
        x = _rand(rng, 2, 1, cfg.d_model)
        ref_out, ref_c = ref_attn.gqa_decode(p_j, jnp.asarray(x), ref_cfg,
                                             ref_c, window=window)
        out, c = attention.gqa_decode(p_t, _t(x), cfg, c, window=window)
        _close(out, ref_out, err_msg=f"step {i}", **TOL)
        for key in ("k", "v", "len"):
            _close(c[key], ref_c[key], err_msg=f"step {i} {key}", **TOL)
    assert int(c["len"]) == steps


def test_gqa_decode_cross_matches_reference():
    cfg, ref_cfg = _cfgs("seamless-m4t-large-v2")
    p_j, p_t = _params(attention.gqa_defs(cfg), 7)
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 1, cfg.d_model)
    ek = _rand(rng, 2, 30, cfg.num_kv_heads, cfg.head_dim)
    ev = _rand(rng, 2, 30, cfg.num_kv_heads, cfg.head_dim)
    ref = ref_attn.gqa_decode_cross(p_j, jnp.asarray(x), ref_cfg,
                                    (jnp.asarray(ek), jnp.asarray(ev)), 30)
    port = attention.gqa_decode_cross(p_t, _t(x), cfg, (_t(ek), _t(ev)), 30)
    _close(port, ref)


def test_mla_fwd_and_decode_match_reference():
    """MLA's output and compressed cache (ckv, k_rope), then three
    absorbed decode steps on a cache of 6 slots."""
    cfg, ref_cfg = _cfgs("deepseek-v2-lite-16b", attn_chunk=16)
    p_j, p_t = _params(attention.mla_defs(cfg), 9)
    rng = np.random.default_rng(10)
    x = _rand(rng, 2, 32, cfg.d_model)
    ref_out, (ref_ckv, ref_kr) = ref_attn.mla_fwd(p_j, jnp.asarray(x),
                                                  ref_cfg)
    out, (ckv, kr) = attention.mla_fwd(p_t, _t(x), cfg)
    _close(out, ref_out)
    _close(ckv, ref_ckv)
    _close(kr, ref_kr)
    m = cfg.mla
    ref_c = {"ckv": jnp.zeros((2, 6, m.kv_lora_rank)),
             "k_rope": jnp.zeros((2, 6, m.qk_rope_head_dim)),
             "len": jnp.zeros((), jnp.int32)}
    c = {k: _t(np.asarray(a)) for k, a in ref_c.items()}
    for i in range(3):
        xs = _rand(rng, 2, 1, cfg.d_model)
        ref_o, ref_c = ref_attn.mla_decode(p_j, jnp.asarray(xs), ref_cfg,
                                           ref_c)
        o, c = attention.mla_decode(p_t, _t(xs), cfg, c)
        _close(o, ref_o, err_msg=f"step {i}", **TOL)
        for key in ("ckv", "k_rope", "len"):
            _close(c[key], ref_c[key], err_msg=f"step {i} {key}", **TOL)
