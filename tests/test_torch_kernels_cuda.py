"""The CUDA kernels against their plain PyTorch versions, on the card.

Skips with a reason where ``torch.cuda.is_available()`` is False; runs on
a machine with an NVIDIA GPU (``python -m pytest -q -m cuda
tests/test_torch_kernels_cuda.py``). It imports no JAX: the machine with
the card has none. Results must be exact (int32 exactly; float32 with
rtol=0, since one slot — or an integer-valued tie-sum — is selected per
read). Each CUDA call must launch its kernel exactly once and never reach
the plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mvcc_resolve as mod

INF = np.iinfo(np.int32).max
SHAPES = [(7, 4, 3), (64, 8, 16), (300, 16, 250), (1, 1, 1), (129, 2, 129),
          (10240, 4, 8), (10240, 8, 8), (1000, 5, 33)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    plain = {"resolve": mod.mvcc_resolve_plain,
             "masked": mod.mvcc_resolve_masked_plain}

    def boom(*args):
        raise AssertionError("a CUDA call reached the plain version")

    monkeypatch.setattr(mod, "mvcc_resolve_plain", boom)
    monkeypatch.setattr(mod, "mvcc_resolve_masked_plain", boom)
    return plain


def _inputs(seed, b, k, d, dtype, masked):
    rng = np.random.default_rng(seed)
    begin = np.sort(rng.integers(0, 100, (b, k)).astype(np.int32), axis=1)
    end = np.concatenate([begin[:, 1:], np.full((b, 1), INF, np.int32)],
                         axis=1)
    data = rng.integers(-1000, 1000, (b, k, d)).astype(dtype)
    ts = rng.integers(0, 120, b).astype(np.int32)
    arrays = [begin, end, data, ts]
    if masked:
        rec = rng.integers(-1, 3, (b, k)).astype(np.int32)
        want = rng.integers(0, 3, b).astype(np.int32)
        arrays = [begin, end, rec, want, data, ts]
    return [torch.from_numpy(a) for a in arrays]


def _run(name, fn, plain, cpu_inputs):
    expect = plain(*cpu_inputs)
    gpu = [x.cuda() for x in cpu_inputs]
    before = mod.LAUNCHES[name]
    vals, found = fn(*gpu)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[name] == before + 1
    assert vals.dtype == expect[0].dtype and vals.is_cuda
    torch.testing.assert_close(vals.cpu(), expect[0], rtol=0, atol=0)
    assert torch.equal(found.cpu(), expect[1])


@pytest.mark.parametrize("b,k,d", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_resolve_kernel_matches_plain(cuda, b, k, d, dtype):
    _run("mvcc_resolve", mod.mvcc_resolve, cuda["resolve"],
         _inputs(b * 1000 + k, b, k, d, dtype, masked=False))


@pytest.mark.parametrize("b,k,d", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_resolve_masked_kernel_matches_plain(cuda, b, k, d, dtype):
    _run("mvcc_resolve_masked", mod.mvcc_resolve_masked, cuda["masked"],
         _inputs(b * 1000 + k + 7, b, k, d, dtype, masked=True))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_kernels_sum_tied_begins(cuda, dtype):
    begin = torch.tensor([[3, 5, 5, 1], [5, 5, 5, 9]], dtype=torch.int32)
    end = torch.full((2, 4), INF, dtype=torch.int32)
    data = torch.from_numpy(
        (np.arange(24).reshape(2, 4, 3) + 1).astype(dtype))
    ts = torch.tensor([6, 6], dtype=torch.int32)
    rec = torch.tensor([[0, 0, 0, 0], [0, 1, 0, 0]], dtype=torch.int32)
    want = torch.tensor([0, 0], dtype=torch.int32)
    _run("mvcc_resolve", mod.mvcc_resolve, cuda["resolve"],
         [begin, end, data, ts])
    _run("mvcc_resolve_masked", mod.mvcc_resolve_masked, cuda["masked"],
         [begin, end, rec, want, data, ts])


def test_kernel_rejects_non_contiguous(cuda):
    begin, end, data, ts = (x.cuda() for x in _inputs(1, 8, 4, 6, np.int32,
                                                      masked=False))
    with pytest.raises(ValueError, match="contiguous"):
        mod.mvcc_resolve(begin, end, data[:, :, ::2], ts)
