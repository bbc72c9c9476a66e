"""The training path's device-independent results, on the card.

Skips with a reason where ``torch.cuda.is_available()`` is False; runs on
a machine with an NVIDIA GPU (``python -m pytest -q -m cuda
tests/test_torch_training_cuda.py``). It imports no JAX.

``compress_grads`` must give the card's gradient the bits it gives the
CPU copy (as the CPU's equal the reference's): CUDA divides a tensor by a
Python number as a product with the number's rounded reciprocal, which
for ~5 % of maxima puts the int8 scale one ulp off the quotient and so
changes every element of the leaf.

The blockwise attention (non-causal, windowed) pads its keys and values
to a whole chunk. torch 2.11's DTensor gave ``F.pad``'s output a spec
with fewer placements than the mesh has dims, so a later view raised on
any mesh; reduced seamless-m4t-large-v2 (cross-attention) and hymba-1.5b
(windowed layers) take that path, and their sharded step on two thread
ranks must hold to the unsharded step.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.training.compression import CompressionConfig, compress_grads

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def _maxima_off_by_the_reciprocal(n):
    """``n`` float32 maxima whose product with the rounded 1/127 is not
    their quotient by 127."""
    rng = np.random.default_rng(0)
    m = rng.uniform(0.5, 4.0, 4096).astype(np.float32)
    off = m[(m / np.float32(127)) != (m * (np.float32(1) / np.float32(127)))]
    assert off.size >= n
    return off[:n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_grads_card_equals_cpu(cuda, dtype):
    rng = np.random.default_rng(1)
    grads = {}
    for i, m in enumerate(_maxima_off_by_the_reciprocal(8)):
        g = rng.uniform(-1, 1, (64, 96)).astype(np.float32) * m * 0.9
        g[3, 5] = m
        grads[f"w{i}"] = torch.from_numpy(g).to(dtype)
    grads["small"] = torch.ones(8, dtype=dtype)       # under min_size
    cfg = CompressionConfig()
    want = compress_grads(grads, cfg)
    got = compress_grads({k: v.cuda() for k, v in grads.items()}, cfg)
    for name, w in want.items():
        g = got[name].cpu()
        assert g.dtype == w.dtype and torch.equal(g, w), name
    # the CPU's scale is the true quotient
    for name, g in grads.items():
        if g.numel() >= cfg.min_size:
            m = np.float32(g.float().abs().max())
            scale = m / np.float32(127) + np.float32(1e-12)
            q = np.clip(np.round(g.float().numpy() / scale), -127, 127)
            np.testing.assert_array_equal(
                want[name].numpy(), q.astype(np.float32) * scale)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "hymba-1.5b"])
def test_blockwise_attention_pads_on_a_mesh(cuda, arch):
    import chip_smoke as cs
    case = cs.sharded_cases("reduced", archs=(arch,), expert_tp=False)[0]
    case = dict(case, name=f"{arch} 1x2", mesh="1x2", steps=1)
    assert case["seq"] % case["cfg"].attn_chunk
    want = cs.unsharded_family(case, "cuda")
    recs = cs.thread_ranks(
        functools.partial(cs.sharded_world, cases=[case], device="cuda"),
        2, device="cuda", mesh=cs.SHARDED_MESHES["1x2"])
    out = cs.sharded_checks(case, want, [r[case["name"]] for r in recs],
                            cs.GRAD_TOL)
    assert out["loss"] <= cs.GRAD_TOL and out["grads"][0] <= cs.GRAD_TOL
