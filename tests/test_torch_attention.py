"""The attention kernels' plain versions against the JAX package: the
Pallas ``decode_attention`` / ``flash_attention_causal`` in interpret mode
at ``tests/test_kernels.py``'s shape sweeps, the model path's blockwise
``flash_attention``, and the edge cases the CUDA kernels must share
(poisoned cache tail, ``kv_len = 0``, scalar ``kv_len``, S not a multiple
of the block).

Tolerances are the reference tests': float32 1e-5; bfloat16 2e-2
(decode) and 3e-2 (prefill) — one bf16 rounding of outputs of order 1,
plus float32 reassociation of the online softmax; the model path's
blockwise attention 1e-4, as ``test_flash_kernel_matches_model_path``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_
from repro.kernels import ops as ref_ops
from repro.models.layers import flash_attention as ref_flash_model
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a torch CPU tensor of
    ``dtype`` (bf16 rounded once, by torch, and handed to JAX)."""
    t = torch.from_numpy(a.astype(np.float32)).to(DTYPES[dtype][1])
    return jnp.asarray(t.float().numpy(), DTYPES[dtype][0]), t


def _close(ref, port, tol):
    np.testing.assert_allclose(np_(port.float()),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,kvh,g,dh,t", [
    (1, 1, 1, 64, 64), (3, 2, 4, 64, 257), (2, 5, 3, 128, 1024),
    (4, 8, 1, 128, 96),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_plain_matches_pallas(b, kvh, g, dh, t, dtype):
    rng = np.random.default_rng(b * 37 + t)
    q_j, q = _both(rng.standard_normal((b, kvh, g, dh)), dtype)
    k_j, k = _both(rng.standard_normal((b, t, kvh, dh)), dtype)
    v_j, v = _both(rng.standard_normal((b, t, kvh, dh)), dtype)
    kl = rng.integers(1, t + 1, b).astype(np.int32)
    ref = ref_ops.decode_attention(q_j, k_j, v_j, jnp.asarray(kl),
                                   block_t=128)
    port = ops.decode_attention(q, k, v, torch.from_numpy(kl))
    assert port.dtype == q.dtype and port.shape == q.shape
    _close(ref, port, 1e-5 if dtype == "float32" else 2e-2)


def test_decode_masking_ignores_poisoned_tail():
    """Cache rows at and beyond kv_len must not influence the output."""
    rng = np.random.default_rng(0)
    b, kvh, g, dh, t = 2, 2, 2, 32, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, kvh, g, dh), (b, t, kvh, dh), (b, t, kvh, dh)))
    kl = torch.tensor([40, 90], dtype=torch.int32)
    o1 = ops.decode_attention(q, k, v, kl)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate((40, 90)):
        k2[i, n:] = 1e9
        v2[i, n:] = -1e9
    o2 = ops.decode_attention(q, k2, v2, kl)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    ref = ref_ops.decode_attention(*(jnp.asarray(x.numpy())
                                     for x in (q, k2, v2, kl)), block_t=64)
    _close(ref, o2, 1e-5)


def test_decode_empty_rows_give_zeros_and_scalar_kv_len():
    """kv_len = 0 is a row with nothing visible: zeros, not NaN (the
    Pallas kernel's m_safe / max(l, 1e-30)); a scalar kv_len applies to
    every sequence."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((3, 2, 3, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 40, 2, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 40, 2, 16)).astype(
        np.float32))
    out = ops.decode_attention(q, k, v, torch.tensor([0, 7, 0],
                                                     dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    ref = ref_ops.decode_attention(*(jnp.asarray(x.numpy())
                                     for x in (q, k, v)),
                                   jnp.asarray([0, 7, 0], jnp.int32))
    _close(ref, out, 1e-5)
    scalar = ops.decode_attention(q, k, v, 7)
    full = ops.decode_attention(q, k, v, torch.full((3,), 7,
                                                    dtype=torch.int32))
    assert torch.equal(scalar, full)
    with pytest.raises(ValueError, match="kv_len"):
        ops.decode_attention(q, k, v, torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("b,s,kvh,g,dh,bq,bk", [
    (1, 128, 1, 1, 32, 64, 64), (2, 256, 2, 3, 64, 64, 128),
    (1, 512, 4, 2, 128, 256, 256), (2, 128, 2, 1, 64, 128, 32),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_matches_pallas(b, s, kvh, g, dh, bq, bk, dtype):
    rng = np.random.default_rng(s + b)
    q_j, q = _both(rng.standard_normal((b, s, kvh, g, dh)), dtype)
    k_j, k = _both(rng.standard_normal((b, s, kvh, dh)), dtype)
    v_j, v = _both(rng.standard_normal((b, s, kvh, dh)), dtype)
    ref = ref_ops.flash_attention_causal(q_j, k_j, v_j, block_q=bq,
                                         block_k=bk)
    port = ops.flash_attention_causal(q, k, v)
    assert port.dtype == q.dtype and port.shape == q.shape
    _close(ref, port, 1e-5 if dtype == "float32" else 3e-2)


def test_flash_plain_matches_model_path():
    """The plain version == the model's blockwise jnp attention (the
    reference serving prefill's function)."""
    rng = np.random.default_rng(3)
    b, s, kvh, g, dh = 2, 256, 2, 2, 32
    q = rng.standard_normal((b, s, kvh * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    ref = ref_flash_model(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, chunk=64)
    port = ops.flash_attention_causal(
        torch.from_numpy(q).reshape(b, s, kvh, g, dh), torch.from_numpy(k),
        torch.from_numpy(v))
    np.testing.assert_allclose(np_(port.reshape(b, s, -1, dh)),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 100, 300])
def test_flash_plain_any_length(s):
    """S need not be a multiple of the block (the Pallas wrapper asserts
    it is): the plain version against the full-softmax oracle and the
    model path at the same ragged S."""
    rng = np.random.default_rng(s)
    b, kvh, g, dh = 1, 5, 3, 64
    q = rng.standard_normal((b, s, kvh, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    port = ops.flash_attention_causal(*(torch.from_numpy(x)
                                        for x in (q, k, v)))
    oracle = ref_ops.flash_attention_causal_ref(*(jnp.asarray(x)
                                                  for x in (q, k, v)))
    _close(oracle, port, 1e-5)
    model = ref_flash_model(jnp.asarray(q.reshape(b, s, kvh * g, dh)),
                            jnp.asarray(k), jnp.asarray(v), causal=True,
                            chunk=64)
    np.testing.assert_allclose(np_(port.reshape(b, s, -1, dh)),
                               np.asarray(model), rtol=1e-4, atol=1e-4)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros((1, 2, 3, 8))
    k = torch.zeros((1, 5, 2, 8))
    with pytest.raises(TypeError, match="dtype"):
        ops.decode_attention(q, k.to(torch.bfloat16), k, 1)
    with pytest.raises(ValueError, match="match"):
        ops.decode_attention(q, torch.zeros((1, 5, 3, 8)),
                             torch.zeros((1, 5, 3, 8)), 1)
    with pytest.raises(ValueError, match="match"):
        ops.flash_attention_causal(torch.zeros((1, 4, 2, 3, 8)), k, k)
    with pytest.raises(ValueError, match="ranks"):
        ops.flash_attention_causal(q, k, k)


# ---------------------------------------------------------------------------
# the wrappers' route choice and input checks (no card needed)
# ---------------------------------------------------------------------------
from repro_torch.kernels import flash_attention as fmod  # noqa: E402


def _flash_args(dtype, dh, s=8, g=3):
    return (torch.zeros((1, s, 2, g, dh), dtype=dtype),
            torch.zeros((1, s, 2, dh), dtype=dtype),
            torch.zeros((1, s, 2, dh), dtype=dtype))


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 40, "cuda_cores"), (torch.bfloat16, 8, "cuda_cores"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    (torch.float32, 192, "tf32x3"), (torch.float32, 36, "cuda_cores"),
])
def test_flash_route_by_dtype_and_dh(dtype, dh, route):
    """bf16 with Dh % 16 == 0 goes to the tensor cores in bf16, float32
    with Dh % 8 == 0 to them in 3xTF32 (three tf32 products hold its 1e-5
    tolerance, one would not); other Dh to the CUDA cores."""
    assert fmod.flash_route(*_flash_args(dtype, dh)) == route


def test_flash_route_needs_16_byte_alignment():
    """TMA and the 16-byte Q loads need aligned tensors: a view that
    starts 2 bytes into its storage takes the CUDA-core kernel."""
    q, k, v = _flash_args(torch.bfloat16, 64)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert fmod.flash_route(shifted, k, v) == "cuda_cores"
    assert fmod.flash_route(q, k, v, out=flat[1:].view(q.shape)) \
        == "cuda_cores"
    assert fmod.flash_route(q, k, v) == "wgmma"


@pytest.mark.parametrize("which", range(4))
def test_flash_float32_route_needs_16_byte_alignment(which):
    """The tf32x3 route's TMA maps and 16-byte Q loads need aligned
    tensors too: a float32 q, k, v or out 4 bytes into its storage takes
    the CUDA-core kernel."""
    args = list(_flash_args(torch.float32, 64))
    args.append(torch.zeros_like(args[0]))
    assert fmod.flash_route(*args) == "tf32x3"
    flat = torch.zeros(args[which].numel() + 1)
    args[which] = flat[1:].view(args[which].shape)
    assert args[which].is_contiguous() and args[which].data_ptr() % 16 != 0
    assert fmod.flash_route(*args) == "cuda_cores"


@pytest.mark.parametrize("name", ["decode_attention",
                                  "flash_attention_causal"])
def test_cpu_calls_launch_no_kernel(name):
    """A CPU call takes the plain version and counts no launch, of any
    route."""
    if name == "decode_attention":
        args = (torch.zeros((1, 2, 3, 64), dtype=torch.bfloat16),
                torch.zeros((1, 5, 2, 64), dtype=torch.bfloat16),
                torch.zeros((1, 5, 2, 64), dtype=torch.bfloat16), 3)
    else:
        args = _flash_args(torch.bfloat16, 64)
    before = dict(ops.LAUNCHES)
    out = getattr(ops, name)(*args)
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    assert ops.LAUNCHES == before
    assert {"flash_attention_causal/wgmma", "flash_attention_causal/tf32x3",
            "flash_attention_causal/cuda_cores"} <= set(ops.LAUNCHES)


def test_wrappers_reject_bad_inputs_more():
    """The checks that hold before any route is chosen: kv_len's type and
    shape, k/v shape agreement, the batch of k against q's."""
    q = torch.zeros((2, 2, 3, 16))
    k = torch.zeros((2, 5, 2, 16))
    with pytest.raises(TypeError, match="kv_len"):
        ops.decode_attention(q, k, k, torch.ones(2))
    with pytest.raises(ValueError, match="kv_len"):
        ops.decode_attention(q, k, k, torch.ones((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="!="):
        ops.decode_attention(q, k, torch.zeros((2, 6, 2, 16)), 1)
    with pytest.raises(ValueError, match="match"):
        ops.decode_attention(q, torch.zeros((3, 5, 2, 16)),
                             torch.zeros((3, 5, 2, 16)), 1)
    qf, kf, _ = _flash_args(torch.float32, 16)
    with pytest.raises(ValueError, match="match"):
        ops.flash_attention_causal(qf, torch.zeros((2, 8, 2, 16)),
                                   torch.zeros((2, 8, 2, 16)))
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention_causal(qf.half(), kf.half(), kf.half())
