"""Port kernels' plain versions vs the Pallas kernels (interpret mode).

``repro_torch.kernels.mvcc_resolve_plain`` / ``_masked_plain`` (the
CPU path and the CUDA kernels' oracle) must equal the reference Pallas
kernels run in interpret mode — exactly: one slot, or an integer tie-sum,
is selected per read, so there is no rounding (float32 compared with
rtol=0). That includes the Pallas tie rule: every visible slot tied at
the largest begin is SUMMED, which differs from ``repro/kernels/ref.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops

INF = np.iinfo(np.int32).max
SHAPES = [(7, 4, 3), (64, 8, 16), (300, 16, 250), (1, 1, 1), (129, 2, 129)]


def _version_store(rng, b, k, d, dtype):
    begin = np.sort(rng.integers(0, 100, (b, k)).astype(np.int32), axis=1)
    end = np.concatenate([begin[:, 1:], np.full((b, 1), INF, np.int32)],
                         axis=1)
    data = rng.integers(-1000, 1000, (b, k, d)).astype(dtype)
    return begin, end, data


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pallas(fn, *arrays):
    v, f = fn(*(jnp.asarray(a) for a in arrays), block_b=64, block_d=64,
              interpret=True)
    return np.asarray(v), np.asarray(f)


def _same(port, ref):
    np.testing.assert_array_equal(port[1].numpy(), ref[1])
    np.testing.assert_allclose(port[0].numpy(), ref[0], rtol=0, atol=0)
    assert port[0].numpy().dtype == ref[0].dtype


@pytest.mark.parametrize("b,k,d", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_plain_resolve_matches_pallas(b, k, d, dtype):
    rng = np.random.default_rng(b * 1000 + k)
    begin, end, data = _version_store(rng, b, k, d, dtype)
    ts = rng.integers(0, 120, b).astype(np.int32)
    ref = _pallas(ref_ops.mvcc_resolve, begin, end, data, ts)
    _same(ops.mvcc_resolve_plain(*_t(begin, end, data, ts)), ref)


@pytest.mark.parametrize("b,k,d", SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_plain_resolve_masked_matches_pallas(b, k, d, dtype):
    rng = np.random.default_rng(b * 1000 + k + 7)
    begin, end, data = _version_store(rng, b, k, d, dtype)
    rec = rng.integers(-1, 3, (b, k)).astype(np.int32)     # -1 = free slot
    want = rng.integers(0, 3, b).astype(np.int32)
    ts = rng.integers(0, 120, b).astype(np.int32)
    ref = _pallas(ref_ops.mvcc_resolve_masked, begin, end, rec, want, data,
                  ts)
    _same(ops.mvcc_resolve_masked_plain(*_t(begin, end, rec, want, data,
                                            ts)), ref)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_duplicate_begins_follow_pallas_tie_sum(dtype):
    """Two visible slots tied at the largest begin: Pallas sums them (and
    ``ref.py`` would take the first); the port follows Pallas."""
    begin = np.array([[3, 5, 5, 1], [5, 5, 5, 9]], np.int32)
    end = np.full((2, 4), INF, np.int32)
    data = (np.arange(2 * 4 * 3).reshape(2, 4, 3) + 1).astype(dtype)
    ts = np.array([6, 6], np.int32)
    ref = _pallas(ref_ops.mvcc_resolve, begin, end, data, ts)
    np.testing.assert_array_equal(ref[0][0], data[0, 1] + data[0, 2])
    np.testing.assert_array_equal(ref[0][1], data[1, :3].sum(0))
    _same(ops.mvcc_resolve_plain(*_t(begin, end, data, ts)), ref)
    rec = np.array([[0, 0, 0, 0], [0, 1, 0, 0]], np.int32)
    want = np.array([0, 0], np.int32)
    ref_m = _pallas(ref_ops.mvcc_resolve_masked, begin, end, rec, want,
                    data, ts)
    np.testing.assert_array_equal(ref_m[0][1], data[1, 0] + data[1, 2])
    _same(ops.mvcc_resolve_masked_plain(*_t(begin, end, rec, want, data,
                                            ts)), ref_m)


def test_resolve_semantics_chain():
    """Hand-built chain: version visible iff begin <= ts < end."""
    begin = np.array([[1, 5, 9]], np.int32)
    end = np.array([[5, 9, INF]], np.int32)
    data = (np.arange(3, dtype=np.int32) + 10).reshape(1, 3, 1)
    for ts, want, found in [(0, 0, False), (1, 10, True), (4, 10, True),
                            (5, 11, True), (8, 11, True), (9, 12, True),
                            (100, 12, True)]:
        t = np.array([ts], np.int32)
        ref = _pallas(ref_ops.mvcc_resolve, begin, end, data, t)
        v, f = ops.mvcc_resolve(*_t(begin, end, data, t))
        assert bool(f[0]) == found == bool(ref[1][0]), ts
        assert int(v[0, 0]) == int(ref[0][0, 0]), ts
        if found:
            assert int(v[0, 0]) == want, ts


def test_cpu_wrappers_take_plain_path_and_launch_nothing():
    rng = np.random.default_rng(5)
    begin, end, data = _version_store(rng, 33, 4, 8, np.int32)
    ts = rng.integers(0, 120, 33).astype(np.int32)
    rec = rng.integers(-1, 3, (33, 4)).astype(np.int32)
    want = rng.integers(0, 3, 33).astype(np.int32)
    before = dict(ops.LAUNCHES)
    _same(ops.mvcc_resolve(*_t(begin, end, data, ts)),
          tuple(x.numpy() for x in ops.mvcc_resolve_plain(
              *_t(begin, end, data, ts))))
    _same(ops.mvcc_resolve_masked(*_t(begin, end, rec, want, data, ts)),
          tuple(x.numpy() for x in ops.mvcc_resolve_masked_plain(
              *_t(begin, end, rec, want, data, ts))))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "payload_dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    begin = torch.zeros((4, 2), dtype=torch.int32)
    end = torch.zeros((4, 2), dtype=torch.int32)
    data = torch.zeros((4, 2, 3), dtype=torch.int32)
    ts = torch.zeros((4,), dtype=torch.int32)
    if bad == "dtype":
        ts = ts.long()
    elif bad == "shape":
        end = end[:3]
    else:
        data = data.double()
    with pytest.raises((TypeError, ValueError)):
        ops.mvcc_resolve(begin, end, data, ts)
