"""The CUDA kernels against their plain PyTorch versions, on the card.

Skips with a reason where ``torch.cuda.is_available()`` is False; runs on
a machine with an NVIDIA GPU (``python -m pytest -q -m cuda
tests/test_torch_kernels_cuda.py``). It imports no JAX: the machine with
the card has none. The resolve kernels must be exact (int32 exactly;
float32 with rtol=0, since one slot — or an integer-valued tie-sum — is
selected per read). The attention kernels sum in another order than
their plain versions: float32 to 1e-5, bfloat16 to 2e-2 (decode) and
3e-2 (prefill), one bf16 rounding of outputs of order 1, as the Pallas
tests. Each CUDA call must launch its kernel exactly once and never
reach the plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mvcc_resolve as mod
# ops binds the plain versions at its import: import it here, before any
# fixture patches them (a later first import would keep the patch)
from repro_torch.kernels import ops  # noqa: F401

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
             "masked": mod.mvcc_resolve_masked_plain,
             "paged": mod.mvcc_resolve_paged_plain}

    def cpu_only(fn):
        def run(*args, **kw):
            tensors = [*args, kw.get("rows")] + list(kw.get("prior") or ())
            if any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in tensors):
                raise AssertionError("a CUDA call reached the plain version")
            return fn(*args, **kw)
        return run

    for name in ("mvcc_resolve_plain", "mvcc_resolve_masked_plain",
                 "mvcc_resolve_paged_plain"):
        monkeypatch.setattr(mod, name, cpu_only(getattr(mod, name)))
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


# ---------------------------------------------------------------------------
# mvcc_resolve_paged: page-table rows into a page slab
# ---------------------------------------------------------------------------
PAGED_SHAPES = [(23, 3, 4, 37, 5), (5, 1, 1, 1, 1), (64, 2, 8, 129, 8),
                (4099, 3, 5, 1000, 33), (200_000, 2, 8, 10240, 8)]


def _paged_inputs(seed, P, S, max_pages, B, D, dtype, unmapped=0.5):
    """A consistent slab (every begin distinct, so one slot is selected
    per read and float32 sums are exact) and page rows with unmapped
    entries; rows repeat no page where P is small enough to draw them
    without replacement."""
    rng = np.random.default_rng(seed)
    begin = rng.permutation(P * S * 2)[:P * S].reshape(P, S).astype(
        np.int32)
    end = begin + rng.integers(1, 30, (P, S)).astype(np.int32)
    data = rng.integers(-1000, 1000, (P, S, D)).astype(dtype)
    if P <= 5000:
        rows = np.argsort(rng.random((B, P)), axis=1)[:, :max_pages]
    else:
        rows = rng.integers(0, P, (B, max_pages))
    rows = rows.astype(np.int32)
    # ts near a version of the row's first page: most reads find one
    ts = begin[rows[:, 0], 0] + rng.integers(0, 10, B).astype(np.int32)
    rows[rng.random((B, max_pages)) < unmapped] = -1
    return [torch.from_numpy(a) for a in (rows, begin, end, data, ts)]


@pytest.mark.parametrize("P,S,max_pages,b,d", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_resolve_paged_kernel_matches_plain(cuda, P, S, max_pages, b, d,
                                            dtype):
    _run("mvcc_resolve_paged", mod.mvcc_resolve_paged, cuda["paged"],
         _paged_inputs(P + b, P, S, max_pages, b, d, dtype))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_resolve_paged_unmapped_and_single_page(cuda, dtype):
    rows, begin, end, data, ts = _paged_inputs(9, 23, 3, 4, 37, 5, dtype)
    rows[[0, 5, 36]] = -1                       # all-unmapped rows
    _run("mvcc_resolve_paged", mod.mvcc_resolve_paged, cuda["paged"],
         [rows, begin, end, data, ts])
    vals, found = mod.mvcc_resolve_paged(*(x.cuda() for x in (
        rows, begin, end, data, ts)))
    assert not found[[0, 5, 36]].any() and (vals[[0, 5, 36]] == 0).all()
    # a fully mapped single-page table: the dense select over that page
    one = (torch.arange(37, dtype=torch.int32) % 23)[:, None].contiguous()
    _run("mvcc_resolve_paged", mod.mvcc_resolve_paged, cuda["paged"],
         [one, begin, end, data, ts])
    v1, f1 = mod.mvcc_resolve_paged(*(x.cuda() for x in (one, begin, end,
                                                         data, ts)))
    vd, fd = mod.mvcc_resolve(*(x.cuda() for x in (
        begin[one[:, 0].long()], end[one[:, 0].long()],
        data[one[:, 0].long()], ts)))
    assert torch.equal(v1, vd) and torch.equal(f1, fd)


def test_resolve_paged_kernel_sums_tied_begins(cuda):
    begin = torch.tensor([[3, 5], [5, 1], [7, 9]], dtype=torch.int32)
    end = torch.full((3, 2), INF, dtype=torch.int32)
    data = torch.arange(12, dtype=torch.int32).reshape(3, 2, 2) + 1
    rows = torch.tensor([[0, 1, -1], [2, -1, 0]], dtype=torch.int32)
    ts = torch.tensor([6, 8], dtype=torch.int32)
    _run("mvcc_resolve_paged", mod.mvcc_resolve_paged, cuda["paged"],
         [rows, begin, end, data, ts])


def test_resolve_paged_rejects_non_contiguous_and_mixed_devices(cuda):
    rows, begin, end, data, ts = _paged_inputs(3, 40, 2, 4, 16, 6,
                                               np.int32)
    g = [x.cuda() for x in (rows, begin, end, data, ts)]
    with pytest.raises(ValueError, match="contiguous"):
        mod.mvcc_resolve_paged(g[0], g[1], g[2], g[3][:, :, ::2], g[4])
    with pytest.raises(ValueError, match="contiguous"):
        mod.mvcc_resolve_paged(g[0].t().contiguous().t(), *g[1:])
    with pytest.raises(ValueError, match="one device"):
        mod.mvcc_resolve_paged(rows, *g[1:])
    with pytest.raises(ValueError, match="one device"):
        mod.mvcc_resolve_paged(*g[:4], ts)


# ---------------------------------------------------------------------------
# the in-place forms: ring rows (mvcc_resolve rows=), pool buckets with a
# prior (mvcc_resolve_masked in_place=True)
# ---------------------------------------------------------------------------
# (R, K, D, B): the dense path's ring at a reduced R with its read batch,
# ragged batches, K and D past one lane group (33, 40)
INPLACE_SHAPES = [(37, 4, 8, 101), (1, 1, 1, 1), (500, 16, 8, 10240),
                  (64, 5, 33, 1000), (200, 40, 3, 77), (100_000, 4, 8, 10243)]


def _ring_inputs(seed, R, K, D, B, dtype, tied=False):
    """A consistent ring (per row 0..K live versions, increasing begins,
    each ending where the next begins, slots rotated by a random head;
    empty slots INF / INF), row ids with out-of-range entries and ts.
    ``tied``: every row's live begins collapse onto one value, so the
    tie-sum rule decides (integer-valued float32 sums stay exact)."""
    rng = np.random.default_rng(seed)
    live = rng.integers(0, K + 1, R)
    steps = np.cumsum(rng.integers(1, 20, (R, K)), axis=1).astype(np.int32)
    start = rng.integers(0, 30, R).astype(np.int32)
    head = rng.integers(0, K, R)
    k = np.arange(K)
    slot = (head[:, None] + k[None, :]) % K               # [R, K]
    is_live = k[None, :] < live[:, None]
    b = start[:, None] + steps
    e = np.concatenate([b[:, 1:], np.full((R, 1), INF, np.int32)], 1)
    e = np.where(k[None, :] + 1 < live[:, None], e, INF)
    if tied:
        b = np.where(is_live, start[:, None], b)
        e = np.where(is_live, INF, e)
    begin = np.full((R, K), INF, np.int32)
    end = np.full((R, K), INF, np.int32)
    rr = np.repeat(np.arange(R)[:, None], K, 1)
    begin[rr[is_live], slot[is_live]] = b[is_live]
    end[rr[is_live], slot[is_live]] = e[is_live]
    data = rng.integers(-1000, 1000, (R, K, D)).astype(dtype)
    rows = rng.integers(-2, R + 2, B).astype(np.int32)
    ts = rng.integers(0, 20 * K + 40, B).astype(np.int32)
    return [torch.from_numpy(a) for a in (begin, end, data, ts, rows)]


def _pool_inputs(seed, NB, S, D, B, dtype):
    """A consistent spill pool: slot s of a bucket holds a version of a
    record that hashes there (or is free: rec -1, begin INF) within
    [12 s, 12 s + 12), so a record's windows never overlap; want ids
    include negatives and records of no bucket slot."""
    rng = np.random.default_rng(seed)
    rec = (np.arange(NB)[:, None]
           + NB * rng.integers(0, 3, (NB, S))).astype(np.int32)
    free = rng.random((NB, S)) < 0.3
    begin = (12 * np.arange(S)[None, :] + rng.integers(0, 6, (NB, S)))
    end = begin + rng.integers(1, 7, (NB, S))
    begin = np.where(free, INF, begin).astype(np.int32)
    end = np.where(free, INF, end).astype(np.int32)
    rec = np.where(free, -1, rec).astype(np.int32)
    data = rng.integers(-1000, 1000, (NB, S, D)).astype(dtype)
    want = rng.integers(-2, 3 * NB, B).astype(np.int32)
    ts = rng.integers(0, 12 * S, B).astype(np.int32)
    return [torch.from_numpy(a) for a in (begin, end, rec, want, data, ts)]


def _prior(seed, B, D, dtype):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-50, 50, (B, D)).astype(dtype)
    found = rng.random(B) < 0.6
    return torch.from_numpy(vals), torch.from_numpy(found)


def _check_form(name, form, fn, plain, args, kw, gpu_kw):
    expect = plain(*args, **kw)
    before = dict(mod.LAUNCHES)
    vals, found = fn(*(x.cuda() for x in args), **gpu_kw)
    torch.cuda.synchronize()
    moved = {k: mod.LAUNCHES[k] - before[k] for k in mod.LAUNCHES
             if mod.LAUNCHES[k] != before[k]}
    assert moved == {name: 1, f"{name}/{form}": 1}, moved
    assert vals.dtype == expect[0].dtype and vals.is_cuda
    torch.testing.assert_close(vals.cpu(), expect[0], rtol=0, atol=0)
    assert torch.equal(found.cpu(), expect[1])
    return vals, found


@pytest.mark.parametrize("R,K,D,B", INPLACE_SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("tied", [False, True])
def test_resolve_rows_form_matches_plain(cuda, R, K, D, B, dtype, tied):
    begin, end, data, ts, rows = _ring_inputs(R + K + B, R, K, D, B, dtype,
                                              tied)
    vals, found = _check_form("mvcc_resolve", "rows", mod.mvcc_resolve,
                              cuda["resolve"], [begin, end, data, ts],
                              dict(rows=rows), dict(rows=rows.cuda()))
    outside = ((rows < 0) | (rows >= R)).cuda()
    assert not found[outside].any() and (vals[outside] == 0).all()


@pytest.mark.parametrize("NB,S,D,B", [(7, 4, 3, 50), (1, 1, 1, 1),
                                      (2500, 8, 8, 10240),
                                      (300, 40, 33, 777)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("with_prior", [False, True])
def test_resolve_masked_in_place_matches_plain(cuda, NB, S, D, B, dtype,
                                               with_prior):
    begin, end, rec, want, data, ts = _pool_inputs(NB + S + B, NB, S, D, B,
                                                   dtype)
    prior = _prior(B, B, D, dtype) if with_prior else None
    gpu_prior = None if prior is None else tuple(x.cuda() for x in prior)
    vals, found = _check_form(
        "mvcc_resolve_masked", "rows", mod.mvcc_resolve_masked,
        cuda["masked"], [begin, end, rec, want, data, ts],
        dict(in_place=True, prior=prior),
        dict(in_place=True, prior=gpu_prior))
    if with_prior:
        hit = gpu_prior[1]
        assert found[hit].all() and torch.equal(vals[hit], gpu_prior[0][hit])


def test_in_place_forms_equal_the_windows_forms(cuda):
    """The rows form over a ring equals the windows form over the rows'
    gathered windows; the pool form with a prior equals the windows form
    over the gathered buckets, then the select."""
    begin, end, data, ts, rows = (x.cuda() for x in _ring_inputs(
        3, 300, 4, 8, 2000, np.int32))
    rows = rows.clamp(0, 299)
    v1, f1 = mod.mvcc_resolve(begin, end, data, ts, rows=rows)
    r = rows.long()
    v2, f2 = mod.mvcc_resolve(begin[r], end[r], data[r], ts)
    assert torch.equal(v1, v2) and torch.equal(f1, f2)
    pb, pe, prec, want, pd, _ = (x.cuda() for x in _pool_inputs(
        4, 100, 8, 8, 2000, np.int32))
    s1 = mod.mvcc_resolve_masked(pb, pe, prec, want, pd, ts, in_place=True,
                                 prior=(v1, f1))
    bkt = (want.clamp(min=0) % 100).long()
    sv, sf = mod.mvcc_resolve_masked(pb[bkt], pe[bkt], prec[bkt], want,
                                     pd[bkt], ts)
    assert torch.equal(s1[0], torch.where(f1[:, None], v1, sv))
    assert torch.equal(s1[1], f1 | sf)


def test_in_place_forms_reject_non_contiguous_and_mixed_devices(cuda):
    begin, end, data, ts, rows = (x.cuda() for x in _ring_inputs(
        5, 40, 4, 6, 16, np.int32))
    with pytest.raises(ValueError, match="contiguous"):
        mod.mvcc_resolve(begin, end, data[:, :, ::2], ts, rows=rows)
    with pytest.raises(ValueError, match="contiguous"):
        mod.mvcc_resolve(begin, end, data, ts,
                         rows=torch.stack([rows, rows], 1)[:, 0])
    with pytest.raises(ValueError, match="one device"):
        mod.mvcc_resolve(begin, end, data, ts, rows=rows.cpu())
    pb, pe, prec, want, pd, pts = (x.cuda() for x in _pool_inputs(
        6, 9, 4, 6, 16, np.int32))
    p_vals, p_found = (x.cuda() for x in _prior(7, 16, 6, np.int32))
    with pytest.raises(ValueError, match="contiguous"):
        mod.mvcc_resolve_masked(pb, pe, prec, want, pd, pts, in_place=True,
                                prior=(p_vals.t().contiguous().t(), p_found))
    with pytest.raises(ValueError, match="one device"):
        mod.mvcc_resolve_masked(pb, pe, prec, want, pd, pts, in_place=True,
                                prior=(p_vals, p_found.cpu()))
    with pytest.raises(ValueError, match="one device"):
        mod.mvcc_resolve_masked(pb, pe, prec, want.cpu(), pd, pts,
                                in_place=True)


@pytest.mark.parametrize("kw", [
    dict(ring_slots=2, spill_buckets=16, spill_slots=4),
    dict(ring_slots=2, spill_buckets=16, spill_slots=4, n_shards=2),
    dict(ring_slots=4, spill_buckets=16, spill_slots=4, paged=True,
         page_slots=2, pages_per_shard=400)],
    ids=["dense", "dense-2-shards", "paged"])
def test_engine_reads_launch_only_in_place_forms(cuda, kw):
    """An engine on the card reads through the in-place forms only, and
    equals its CPU twin read for read."""
    from repro_torch.core import workloads as wl
    from repro_torch.core.engine import BohmEngine

    R = 300
    reads = {}
    for dev in ("cuda", "cpu"):
        eng = BohmEngine(R, wl.make_ycsb(payload_words=4, ops=4), device=dev,
                         **kw)
        rng = np.random.default_rng(11)
        for i in range(5):
            eng.run_batch(wl.gen_ycsb_batch(rng, 64, R, theta=1.1, ops=4,
                                            device=dev))
            if i == 1:
                pin = eng.begin_snapshot()
        scan = wl.gen_scan_batch(np.random.default_rng(12), 32, R, ops=6,
                                 theta=1.1, device=dev)
        mod.reset_launches()
        reads[dev] = (eng.run_readonly_batch(scan, pin)[:2]
                      + eng.snapshot_read(torch.arange(R), pin))
        if dev == "cuda":
            launches = dict(mod.LAUNCHES)
    for name in ("mvcc_resolve", "mvcc_resolve_masked", "mvcc_resolve_paged"):
        assert launches[f"{name}/windows"] == 0
    assert launches["mvcc_resolve_masked/rows"] > 0
    primary = ("mvcc_resolve_paged/rows" if kw.get("paged")
               else "mvcc_resolve/rows")
    assert launches[primary] == launches["mvcc_resolve_masked/rows"]
    for a, b in zip(reads["cuda"], reads["cpu"]):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# mvcc_resolve_paged's rows form: the page table read in place
# ---------------------------------------------------------------------------
# (R, P, S, MaxP, D, B): the paged path's table at a reduced R with its
# read batch; k_max=16 with one slot a page; MaxP * S past one lane group
# (39, 40) and D past it (33); one row, one page
TABLE_SHAPES = [(37, 23, 3, 4, 5, 101), (1, 1, 1, 1, 1, 1),
                (500, 1000, 2, 8, 8, 10240), (300, 200, 1, 16, 8, 777),
                (120, 300, 3, 13, 33, 500), (64, 90, 1, 40, 3, 333),
                (100_000, 200_000, 2, 8, 8, 10243)]


def _table_inputs(seed, R, P, S, max_pages, D, B, dtype, tied=False):
    """A slab, a page table [R, MaxP] and reads: entry j of a row mapped
    with probability 2^-j (entry 0 always, as the engine maps a record's
    first page), page ids drawn with replacement (a row may repeat a
    page, whose slots then count twice) and some >= P (unmapped), row ids
    with entries outside [0, R), ts near a version of the row's first
    page. Begins are distinct unless ``tied``, where they collide often
    and the tie-sum rule decides (integer-valued float32 sums stay
    exact)."""
    rng = np.random.default_rng(seed)
    if tied:
        begin = rng.integers(0, 8, (P, S)).astype(np.int32)
    else:
        begin = rng.permutation(P * S * 2)[:P * S].reshape(P, S).astype(
            np.int32)
    end = begin + rng.integers(1, 30, (P, S)).astype(np.int32)
    data = rng.integers(-1000, 1000, (P, S, D)).astype(dtype)
    table = rng.integers(0, P, (R, max_pages)).astype(np.int32)
    keep = rng.random((R, max_pages)) < 0.5 ** np.arange(max_pages)
    table = np.where(keep, table, -1).astype(np.int32)
    table[rng.random((R, max_pages)) < 0.05] = P + 2     # past the slab
    rows = rng.integers(-2, R + 2, B).astype(np.int32)
    first = np.maximum(table[np.clip(rows, 0, R - 1), 0], 0) % P
    ts = (begin[first, 0] + rng.integers(0, 10, B)).astype(np.int32)
    return [torch.from_numpy(a) for a in (table, begin, end, data, ts, rows)]


@pytest.mark.parametrize("R,P,S,max_pages,D,B", TABLE_SHAPES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("tied", [False, True])
def test_resolve_paged_rows_form_matches_plain(cuda, R, P, S, max_pages, D,
                                               B, dtype, tied):
    table, begin, end, data, ts, rows = _table_inputs(
        R + P + B, R, P, S, max_pages, D, B, dtype, tied)
    vals, found = _check_form(
        "mvcc_resolve_paged", "rows", mod.mvcc_resolve_paged, cuda["paged"],
        [table, begin, end, data, ts], dict(rows=rows),
        dict(rows=rows.cuda()))
    outside = ((rows < 0) | (rows >= R)).cuda()
    assert not found[outside].any() and (vals[outside] == 0).all()


@pytest.mark.parametrize("R,P,S,max_pages,D,B", TABLE_SHAPES[:-1])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_resolve_paged_windows_form_edges(cuda, R, P, S, max_pages, D, B,
                                          dtype):
    """The windows form over the same tables' rows: ids >= P, repeated
    pages, MaxP * S > 32 and D = 33 as in the rows form."""
    table, begin, end, data, ts, rows = _table_inputs(
        R + P + B + 1, R, P, S, max_pages, D, B, dtype, tied=True)
    page_rows = table[rows.clamp(0, R - 1).long()].contiguous()
    _check_form("mvcc_resolve_paged", "windows", mod.mvcc_resolve_paged,
                cuda["paged"], [page_rows, begin, end, data, ts], {}, {})


def test_paged_rows_form_equals_the_windows_form(cuda):
    """The table read in place equals the windows form over the rows'
    gathered table rows (the read path's old call site)."""
    table, begin, end, data, ts, rows = (x.cuda() for x in _table_inputs(
        5, 3000, 6000, 2, 8, 8, 4000, np.int32))
    rows = rows.clamp(0, 2999)
    v1, f1 = mod.mvcc_resolve_paged(table, begin, end, data, ts, rows=rows)
    v2, f2 = mod.mvcc_resolve_paged(table[rows.long()], begin, end, data, ts)
    assert torch.equal(v1, v2) and torch.equal(f1, f2) and f1.any()


def test_paged_rows_form_rejects_bad_inputs(cuda):
    table, begin, end, data, ts, rows = (x.cuda() for x in _table_inputs(
        6, 40, 30, 2, 4, 6, 16, np.int32))
    with pytest.raises(ValueError, match="contiguous"):
        mod.mvcc_resolve_paged(table.t().contiguous().t(), begin, end, data,
                               ts, rows=rows)
    with pytest.raises(ValueError, match="one device"):
        mod.mvcc_resolve_paged(table, begin, end, data, ts, rows=rows.cpu())
    with pytest.raises(ValueError, match="rows must be"):
        mod.mvcc_resolve_paged(table, begin, end, data, ts, rows=rows[:5])


@pytest.mark.parametrize("kw", [
    dict(ring_slots=2, spill_buckets=16, spill_slots=4),
    dict(ring_slots=4, spill_buckets=16, spill_slots=4, paged=True,
         page_slots=2, pages_per_shard=400)],
    ids=["dense", "paged"])
def test_engine_reads_past_the_store(cuda, kw):
    """Ids past the store read the last record and negative ids record 0,
    as the reference's clamped gathers do, on the card as on the CPU:
    ``snapshot_read``, ``run_readonly_batch`` and ``snapshot_windows``."""
    from repro_torch.core import workloads as wl
    from repro_torch.core.engine import BohmEngine
    from repro_torch.core.txn import make_batch

    R = 300
    ids = np.array([R, R + 3, 2 * R + 1, -1, -5, R - 1, 0, 7], np.int32)
    got = {}
    for dev in ("cuda", "cpu"):
        eng = BohmEngine(R, wl.make_ycsb(payload_words=4, ops=4), device=dev,
                         **kw)
        rng = np.random.default_rng(13)
        for i in range(5):
            eng.run_batch(wl.gen_ycsb_batch(rng, 64, R, theta=1.1, ops=4,
                                            device=dev))
            if i == 1:
                pin = eng.begin_snapshot()
        scan = make_batch(ids.reshape(2, 4), np.full((2, 1), -1),
                          np.zeros(2), np.zeros((2, 4)), device=dev)
        got[dev] = [*eng.snapshot_read(torch.from_numpy(ids), pin),
                    *eng.run_readonly_batch(scan, pin)[:2],
                    *eng.snapshot_windows(torch.from_numpy(ids))]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a.cpu(), b)
    vals, found = (x.cpu() for x in got["cuda"][:2])
    last, zero = ids.tolist().index(R - 1), ids.tolist().index(0)
    for j in range(3):
        assert torch.equal(vals[j], vals[last]) and found[j] == found[last]
    for j in (3, 4):
        assert torch.equal(vals[j], vals[zero]) and found[j] == found[zero]


# ---------------------------------------------------------------------------
# decode_attention / flash_attention_causal
# ---------------------------------------------------------------------------
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402

# (b, kvh, g, dh, t): tests/test_kernels.py's sweep, the serving shapes
# (8 slots and 1 prefix hit over MaxP * page = 1024) and odd ones
DECODE_SHAPES = [(1, 1, 1, 64, 64), (3, 2, 4, 64, 257), (2, 5, 3, 128, 1024),
                 (4, 8, 1, 128, 96), (8, 5, 3, 64, 1024), (1, 5, 3, 64, 1024),
                 (5, 3, 7, 40, 1000), (2, 2, 32, 128, 33)]
# (b, s, kvh, g, dh): tests/test_kernels.py's sweep, the serving prefill
# shapes, ragged lengths, and Dh up to 192: deepseek-v2-lite's MLA prefill
# (KvH = 16 heads, G = 1, Dh = 128 + 64), a padded third panel (160) and
# a bf16 width off the tensor-core route (184)
FLASH_SHAPES = [(1, 128, 1, 1, 32), (2, 256, 2, 3, 64), (1, 512, 4, 2, 128),
                (2, 128, 2, 1, 64), (1, 128, 5, 3, 64), (1, 384, 5, 3, 64),
                (1, 512, 5, 3, 64), (1, 300, 5, 3, 64), (2, 77, 2, 4, 32),
                (1, 1, 3, 32, 128), (2, 512, 16, 1, 192), (1, 77, 2, 2, 192),
                (1, 130, 2, 3, 160), (1, 100, 2, 2, 184)]
ATT_DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def attn_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    plain = {"decode": dmod.decode_attention_plain,
             "flash": fmod.flash_attention_causal_plain}

    def cpu_only(fn):
        def run(*args, **kw):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in args):
                raise AssertionError("a CUDA call reached the plain version")
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(dmod, "decode_attention_plain",
                        cpu_only(plain["decode"]))
    monkeypatch.setattr(fmod, "flash_attention_causal_plain",
                        cpu_only(plain["flash"]))
    return plain


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _attn_check(name, fn, expect, gpu_args, tol):
    before = mod.LAUNCHES[name]
    out = fn(*gpu_args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[name] == before + 1
    assert out.is_cuda and out.dtype == expect.dtype
    assert out.shape == expect.shape
    torch.testing.assert_close(out.cpu().float(), expect.float(), rtol=tol,
                               atol=tol)
    return out


@pytest.mark.parametrize("b,kvh,g,dh,t", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_decode_attention_kernel_matches_plain(attn_cuda, b, kvh, g, dh, t,
                                               dtype):
    rng = np.random.default_rng(b * 37 + t)
    q = _randn(rng, (b, kvh, g, dh), dtype)
    k = _randn(rng, (b, t, kvh, dh), dtype)
    v = _randn(rng, (b, t, kvh, dh), dtype)
    kl = torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32))
    expect = attn_cuda["decode"](q, k, v, kl)
    _attn_check("decode_attention", dmod.decode_attention, expect,
                [x.cuda() for x in (q, k, v, kl)],
                1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_decode_attention_kernel_edges(attn_cuda, dtype):
    """Poisoned tail, kv_len = 0 rows (zeros), a scalar kv_len and
    kv_len beyond T (clamped, as the Pallas grid ends at T)."""
    rng = np.random.default_rng(5)
    b, kvh, g, dh, t = 4, 2, 3, 64, 130
    q = _randn(rng, (b, kvh, g, dh), dtype).cuda()
    k = _randn(rng, (b, t, kvh, dh), dtype).cuda()
    v = _randn(rng, (b, t, kvh, dh), dtype).cuda()
    kl = torch.tensor([40, 0, 129, 0], dtype=torch.int32, device="cuda")
    o1 = dmod.decode_attention(q, k, v, kl)
    assert torch.isfinite(o1.float()).all()
    assert (o1[1] == 0).all() and (o1[3] == 0).all()
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate((40, 0, 129, 0)):
        k2[i, n:] = 1e9
        v2[i, n:] = -1e9
    assert torch.equal(dmod.decode_attention(q, k2, v2, kl), o1)
    expect = attn_cuda["decode"](q.cpu(), k.cpu(), v.cpu(), kl.cpu())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o1.cpu().float(), expect.float(), rtol=tol,
                               atol=tol)
    scalar = dmod.decode_attention(q, k, v, 77)
    assert torch.equal(scalar, dmod.decode_attention(
        q, k, v, torch.full((b,), 77, dtype=torch.int32, device="cuda")))
    beyond = dmod.decode_attention(q, k, v, t + 50)
    assert torch.equal(beyond, dmod.decode_attention(q, k, v, t))


@pytest.mark.parametrize("b,s,kvh,g,dh", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_flash_attention_kernel_matches_plain(attn_cuda, b, s, kvh, g, dh,
                                              dtype):
    rng = np.random.default_rng(s + b)
    q = _randn(rng, (b, s, kvh, g, dh), dtype)
    k = _randn(rng, (b, s, kvh, dh), dtype)
    v = _randn(rng, (b, s, kvh, dh), dtype)
    expect = attn_cuda["flash"](q, k, v)
    _attn_check("flash_attention_causal", fmod.flash_attention_causal,
                expect, [x.cuda() for x in (q, k, v)],
                1e-5 if dtype == torch.float32 else 3e-2)


def test_attention_kernels_reject_bad_inputs(attn_cuda):
    q = torch.zeros((2, 5, 3, 64), device="cuda")
    k = torch.zeros((2, 8, 5, 64), device="cuda")
    kl = torch.ones((2,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        dmod.decode_attention(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), k, kl)
    with pytest.raises(ValueError, match="G <= 32"):
        dmod.decode_attention(torch.zeros((2, 1, 33, 64), device="cuda"),
                              torch.zeros((2, 8, 1, 64), device="cuda"),
                              torch.zeros((2, 8, 1, 64), device="cuda"), kl)
    with pytest.raises(ValueError, match="Dh <= 192"):
        fmod.flash_attention_causal(
            torch.zeros((1, 4, 1, 1, 256), device="cuda"),
            torch.zeros((1, 4, 1, 256), device="cuda"),
            torch.zeros((1, 4, 1, 256), device="cuda"))
    with pytest.raises(ValueError, match="one device"):
        dmod.decode_attention(q, k.cpu(), k, kl)


# ---------------------------------------------------------------------------
# the Hopper designs: flash's tensor-core route, decode's split over a
# cluster
# ---------------------------------------------------------------------------
def _flash_inputs(seed, b, s, kvh, g, dh, dtype):
    rng = np.random.default_rng(seed)
    return [_randn(rng, shape, dtype) for shape in
            ((b, s, kvh, g, dh), (b, s, kvh, dh), (b, s, kvh, dh))]


@pytest.mark.parametrize("s", [1, 77, 300])
@pytest.mark.parametrize("g", [1, 2, 3, 32])
@pytest.mark.parametrize("dh", [32, 64, 128, 192])
def test_flash_wgmma_route_matches_plain(attn_cuda, dh, g, s):
    """bf16 with Dh % 16 == 0 takes the tensor-core kernel: every panel
    count (Dh 32 and 64 in one 64-column panel, 128 in two, MLA's 192 in
    three), G from 1 to 32 rows a position, ragged S."""
    args = _flash_inputs(dh + g + s, 1, s, 2, g, dh, torch.bfloat16)
    assert fmod.flash_route(*args) == "wgmma"
    expect = attn_cuda["flash"](*args)
    before = mod.LAUNCHES["flash_attention_causal/wgmma"]
    _attn_check("flash_attention_causal", fmod.flash_attention_causal,
                expect, [x.cuda() for x in args], 3e-2)
    assert mod.LAUNCHES["flash_attention_causal/wgmma"] == before + 1


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 192, "wgmma"), (torch.bfloat16, 40, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 192, "cuda_cores")])
def test_flash_variant_counters(attn_cuda, dtype, dh, route):
    """Each launch counts once in total and once for the route it took."""
    args = [x.cuda() for x in _flash_inputs(1, 1, 130, 2, 3, dh, dtype)]
    assert fmod.flash_route(*args) == route
    before = dict(mod.LAUNCHES)
    fmod.flash_attention_causal(*args)
    torch.cuda.synchronize()
    moved = {k: mod.LAUNCHES[k] - before[k] for k in before
             if mod.LAUNCHES[k] != before[k]}
    assert moved == {"flash_attention_causal": 1,
                     f"flash_attention_causal/{route}": 1}


# the model path's routes: layers.flash_attention / attention_decode on
# CUDA tensors launch the kernels where the call's static arguments allow
@pytest.mark.parametrize("dtype", ATT_DTYPES)
@pytest.mark.parametrize("dh,h,kvh", [(64, 6, 2), (192, 4, 4)])
def test_model_flash_route_launches_kernel(attn_cuda, dtype, dh, h, kvh):
    """Causal self-attention with no window launches
    ``flash_attention_causal`` (q viewed as [B, S, KvH, G, Dh]) and
    equals the kernel's plain version; a window or a non-causal call runs
    the blockwise torch code on the card, launching nothing."""
    from repro_torch.models import layers
    rng = np.random.default_rng(dh + h)
    q = _randn(rng, (2, 96, h, dh), dtype).cuda()
    k = _randn(rng, (2, 96, kvh, dh), dtype).cuda()
    v = _randn(rng, (2, 96, kvh, dh), dtype).cuda()
    layers.reset_blockwise()
    before = dict(mod.LAUNCHES)
    out = layers.flash_attention(q, k, v, causal=True, chunk=32)
    torch.cuda.synchronize()
    assert mod.LAUNCHES["flash_attention_causal"] == \
        before["flash_attention_causal"] + 1
    assert layers.BLOCKWISE["flash"] == 0
    expect = attn_cuda["flash"](q.cpu().reshape(2, 96, kvh, h // kvh, dh),
                                k.cpu(), v.cpu()).reshape(2, 96, h, dh)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.cpu().float(), expect.float(), rtol=tol,
                               atol=tol)
    before = dict(mod.LAUNCHES)
    for kw in (dict(causal=True, window=40), dict(causal=False)):
        got = layers.flash_attention(q, k, v, chunk=32, **kw)
        want = layers.flash_attention(q.cpu(), k.cpu(), v.cpu(), chunk=32,
                                      **kw)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
    assert mod.LAUNCHES == before
    assert layers.BLOCKWISE["flash"] == 4


@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_model_decode_route_launches_kernel(attn_cuda, dtype):
    """``attention_decode`` with no window launches ``decode_attention``
    (a 0-d device ``kv_len``, a [B] one and a Python int, which becomes a
    device fill) and equals the CPU's blockwise version; a window runs the
    blockwise code on the card."""
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    b, t, h, kvh, dh = 3, 300, 6, 2, 64
    q = _randn(rng, (b, 1, h, dh), dtype).cuda()
    k = _randn(rng, (b, t, kvh, dh), dtype).cuda()
    v = _randn(rng, (b, t, kvh, dh), dtype).cuda()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    layers.reset_blockwise()
    for i, kl in enumerate((
            torch.tensor(123, dtype=torch.int32, device="cuda"),
            torch.tensor([5, 300, 77], dtype=torch.int32, device="cuda"),
            200)):
        before = mod.LAUNCHES["decode_attention"]
        out = layers.attention_decode(q, k, v, kl)
        torch.cuda.synchronize()
        assert mod.LAUNCHES["decode_attention"] == before + 1
        assert layers.BLOCKWISE["decode"] == i
        kl_cpu = kl.cpu() if isinstance(kl, torch.Tensor) else kl
        want = layers.attention_decode(q.cpu(), k.cpu(), v.cpu(), kl_cpu)
        torch.testing.assert_close(out.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
    assert layers.BLOCKWISE["decode"] == 3       # the CPU's three
    before = dict(mod.LAUNCHES)
    got = layers.attention_decode(q, k, v, 250, window=40)
    want = layers.attention_decode(q.cpu(), k.cpu(), v.cpu(), 250,
                                   window=40)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert mod.LAUNCHES == before


def _decode_chunk(t):
    """Keys a block of decode's 8-block cluster takes (decode_attention.cu:
    roundup(ceil(T / 8), 32))."""
    per_block = -(-t // 8)
    return -(-per_block // 32) * 32


@pytest.mark.parametrize("t", [300, 1024])
@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_decode_split_chunk_edges(attn_cuda, t, dtype):
    """kv_len at the edges of the split: 0, 1, C - 1, C, C + 1 and T, one
    sequence each, with the tail past kv_len poisoned."""
    c = _decode_chunk(t)
    lens = [0, 1, c - 1, c, c + 1, t]
    rng = np.random.default_rng(t)
    b, kvh, g, dh = len(lens), 2, 3, 64
    q = _randn(rng, (b, kvh, g, dh), dtype)
    k = _randn(rng, (b, t, kvh, dh), dtype)
    v = _randn(rng, (b, t, kvh, dh), dtype)
    kl = torch.tensor(lens, dtype=torch.int32)
    expect = attn_cuda["decode"](q, k, v, kl)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    out = _attn_check("decode_attention", dmod.decode_attention, expect,
                      [x.cuda() for x in (q, k, v, kl)], tol)
    assert (out[0] == 0).all()
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens):
        k2[i, n:] = 1e9
        v2[i, n:] = -1e9
    poisoned = dmod.decode_attention(*(x.cuda() for x in (q, k2, v2, kl)))
    assert torch.equal(poisoned, out)


@pytest.mark.parametrize("dtype", ATT_DTYPES)
@pytest.mark.parametrize("which", ["decode", "flash"])
def test_attention_kernels_repeat_bit_equal(attn_cuda, which, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    if which == "decode":
        rng = np.random.default_rng(9)
        args = [_randn(rng, (8, 5, 3, 64), dtype),
                _randn(rng, (8, 1024, 5, 64), dtype),
                _randn(rng, (8, 1024, 5, 64), dtype),
                torch.from_numpy(rng.integers(129, 545, 8).astype(np.int32))]
        fn = dmod.decode_attention
    else:
        args = _flash_inputs(9, 1, 512, 5, 3, 64, dtype)
        fn = fmod.flash_attention_causal
    args = [x.cuda() for x in args]
    first = fn(*args)
    for _ in range(3):
        assert torch.equal(fn(*args), first)


# ---------------------------------------------------------------------------
# flash_attention_causal's backward and the training path
# ---------------------------------------------------------------------------
# (b, s, kvh, g, dh): odd S, G from 1 to 7, Dh from 16 to 192, and the
# training shape (smollm-360m, S = 2,048) cut to B = 1
BWD_SHAPES = [(1, 1, 1, 1, 16), (2, 77, 2, 1, 64), (1, 130, 2, 3, 64),
              (2, 65, 1, 4, 40), (1, 257, 2, 7, 128), (1, 96, 2, 5, 192),
              (2, 200, 1, 6, 32), (1, 2048, 5, 3, 64)]
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _rel_errs(got, want):
    return [float((a.cpu().float() - w.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30))
            for a, w in zip(got, want)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_flash_backward_kernel_matches_plain(attn_cuda, shape, dtype):
    """The three backward kernels against the plain backward on the CPU
    (within BWD_TOL of each gradient's largest magnitude), the same bits
    on a second call, one launch of each kernel a call on the route that
    dtype and Dh pick (wgmma: bf16, Dh % 16 == 0, Dh <= 128)."""
    rng = np.random.default_rng(sum(shape))
    b, s, kvh, g, dh = shape
    q, k, v, dout = (_randn(rng, x, dtype) for x in (
        shape, (b, s, kvh, dh), (b, s, kvh, dh), shape))
    out = attn_cuda["flash"](q, k, v)
    want = fmod.flash_attention_causal_bwd_plain(q, k, v, out, dout)
    args = [x.cuda() for x in (q, k, v, out, dout)]
    route = fmod.flash_bwd_route(*args)
    assert route == ("wgmma" if dtype == torch.bfloat16 and dh % 16 == 0
                     and dh <= fmod.BWD_WGMMA_MAX_DH else "cuda_cores")
    before = dict(mod.LAUNCHES)
    got = fmod.flash_attention_causal_bwd(*args)
    torch.cuda.synchronize()
    moved = {n: mod.LAUNCHES[n] - before[n] for n in before
             if mod.LAUNCHES[n] != before[n]}
    assert moved == {"flash_attention_causal_bwd": 1,
                     f"flash_attention_causal_bwd/{route}": 1,
                     **{f"flash_attention_causal_bwd/{n}": 1
                        for n in fmod.BWD_KERNELS}}
    for a, w in zip(got, want):
        assert a.is_cuda and a.dtype == dtype and a.shape == w.shape
    assert max(_rel_errs(got, want)) <= BWD_TOL[dtype]
    again = fmod.flash_attention_causal_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_attention_operators_launch_once_each(attn_cuda, dtype):
    """The kernels' operators (``torch.ops.repro_torch.*``), called
    directly: one launch each, on the route counters the wrappers count,
    and the wrappers' bits."""
    rng = np.random.default_rng(25)
    q, k, v = (x.cuda() for x in _flash_inputs(25, 2, 96, 2, 3, 64, dtype))
    dout = _randn(rng, tuple(q.shape), dtype).cuda()
    route = fmod.flash_route(q, k, v)
    before = dict(mod.LAUNCHES)
    out = torch.ops.repro_torch.flash_attention_causal(q, k, v)
    grads = torch.ops.repro_torch.flash_attention_causal_bwd(q, k, v, out,
                                                             dout)
    qd = _randn(rng, (2, 2, 3, 64), dtype).cuda()
    kc = _randn(rng, (2, 300, 2, 64), dtype).cuda()
    kl = torch.tensor([17, 300], dtype=torch.int32, device="cuda")
    dec = torch.ops.repro_torch.decode_attention(qd, kc, kc, kl)
    torch.cuda.synchronize()
    moved = {n: mod.LAUNCHES[n] - before[n] for n in before
             if mod.LAUNCHES[n] != before[n]}
    broute = fmod.flash_bwd_route(q, k, v, out, dout)
    assert moved == {"flash_attention_causal": 1,
                     f"flash_attention_causal/{route}": 1,
                     "flash_attention_causal_bwd": 1,
                     f"flash_attention_causal_bwd/{broute}": 1,
                     **{f"flash_attention_causal_bwd/{n}": 1
                        for n in fmod.BWD_KERNELS},
                     "decode_attention": 1}
    assert torch.equal(out, fmod.flash_attention_causal(q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(
        grads, fmod.flash_attention_causal_bwd(q, k, v, out, dout)))
    assert torch.equal(dec, dmod.decode_attention(qd, kc, kc, kl))


def test_tma_kernels_launch_first_on_a_fresh_thread(attn_cuda):
    """The wgmma routes encode their TMA maps with
    ``cuTensorMapEncodeTiled``, which needs a context current on the
    calling thread. Launched as the
    first device work of a fresh thread (as autograd's device thread runs
    an operator's backward that is the first node of its graph), the
    forward and the three backward kernels give this thread's bits."""
    import threading
    rng = np.random.default_rng(27)
    q, k, v = (x.cuda() for x in _flash_inputs(27, 1, 128, 1, 3, 64,
                                                torch.bfloat16))
    dout = _randn(rng, tuple(q.shape), torch.bfloat16).cuda()
    assert fmod.flash_route(q, k, v) == "wgmma"
    want = fmod.flash_attention_causal(q, k, v)
    assert fmod.flash_bwd_route(q, k, v, want, dout) == "wgmma"
    want_grads = fmod.flash_attention_causal_bwd(q, k, v, want, dout)
    torch.cuda.synchronize()
    got = {}

    def run(what):
        try:
            if what == "forward":
                got[what] = fmod.flash_attention_causal(q, k, v)
            else:
                got[what] = fmod.flash_attention_causal_bwd(q, k, v, want,
                                                            dout)
        except Exception as e:                         # noqa: BLE001
            got[what] = e

    for what in ("forward", "backward"):
        t = threading.Thread(target=run, args=(what,))
        t.start()
        t.join()
    torch.cuda.synchronize()
    assert torch.equal(got["forward"], want), got["forward"]
    assert not isinstance(got["backward"], Exception), got["backward"]
    assert all(torch.equal(a, b) for a, b in zip(got["backward"],
                                                 want_grads))


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) DeviceMesh on the card over a real one-rank process group
    (``HashStore``), closed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already open")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_local_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_flash_on_one_rank_dtensors_bit_equal(attn_cuda, one_rank_mesh,
                                              dtype):
    """q, k and v as DTensors of the one-card mesh (replicated, and sharded
    on the batch and on the KV heads over its size-1 dims) through
    ``flash_attention_causal`` and its backward: the plain tensors' bits,
    one forward and one backward launch a call."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    rng = np.random.default_rng(26)
    q, k, v = (x.cuda() for x in _flash_inputs(26, 2, 130, 2, 3, 64, dtype))
    dout = _randn(rng, tuple(q.shape), dtype).cuda()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = fmod.flash_attention_causal(*leaves)
    want.backward(dout)
    for pl in ([Replicate(), Replicate()], [Shard(0), Replicate()],
               [Replicate(), Shard(2)]):
        dleaves = [DTensor.from_local(x.clone(), one_rank_mesh, pl,
                                      run_check=False).requires_grad_(True)
                   for x in (q, k, v)]
        before = dict(mod.LAUNCHES)
        out = fmod.flash_attention_causal(*dleaves)
        out.backward(DTensor.from_local(dout, one_rank_mesh, pl,
                                        run_check=False))
        torch.cuda.synchronize()
        assert mod.LAUNCHES["flash_attention_causal"] == \
            before["flash_attention_causal"] + 1
        assert mod.LAUNCHES["flash_attention_causal_bwd"] == \
            before["flash_attention_causal_bwd"] + 1
        assert tuple(out.placements) == tuple(pl)
        assert torch.equal(out.to_local(), want)
        for d, x in zip(dleaves, leaves):
            assert torch.equal(d.grad.to_local(), x.grad)


@pytest.mark.parametrize("dtype", ATT_DTYPES)
def test_model_flash_route_gradient(attn_cuda, dtype):
    """``layers.flash_attention`` under autograd on the card: the forward
    and backward kernels launch once each, and the gradients equal the
    CPU's (autograd through the blockwise code) within the backward's
    tolerance."""
    from repro_torch.models import layers
    rng = np.random.default_rng(4)
    shapes = ((2, 96, 6, 64), (2, 96, 2, 64), (2, 96, 2, 64))
    cpu = [_randn(rng, x, dtype).requires_grad_(True) for x in shapes]
    card = [x.detach().cuda().requires_grad_(True) for x in cpu]
    dout = _randn(rng, shapes[0], dtype)
    before = dict(mod.LAUNCHES)
    layers.flash_attention(*card, causal=True, chunk=32).backward(
        dout.cuda().transpose(1, 2).contiguous().transpose(1, 2))
    torch.cuda.synchronize()
    assert mod.LAUNCHES["flash_attention_causal"] == \
        before["flash_attention_causal"] + 1
    assert mod.LAUNCHES["flash_attention_causal_bwd"] == \
        before["flash_attention_causal_bwd"] + 1
    layers.flash_attention(*cpu, causal=True, chunk=32).backward(dout)
    tol = BWD_TOL[dtype] if dtype == torch.float32 else 3e-2
    assert max(_rel_errs([x.grad for x in card],
                         [x.grad for x in cpu])) <= tol


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2"])
def test_loss_gradient_card_equals_cpu(attn_cuda, arch):
    """``value_and_grad`` of ``loss_fn`` (reduced config, float32, TF32
    off, remat "full") on the card against the CPU on the same weights:
    2 x layers forward launches, one backward a layer."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.models import layers, transformer
    from repro_torch.training.train_loop import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.enc_dec:
        batch["frames"] = _randn(rng, (2, 64, 160), torch.float32)
    loss, grads = value_and_grad(params, batch, cfg)
    before = dict(mod.LAUNCHES)
    card = layers.unflatten({k: v.cuda() for k, v in
                             layers.flatten(params).items()})
    gloss, ggrads = value_and_grad(
        card, {k: v.cuda() for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    n = cfg.num_layers - (cfg.moe.first_moe_layer if cfg.moe else 0)
    n_prefix = cfg.num_layers - n
    assert mod.LAUNCHES["flash_attention_causal"] - \
        before["flash_attention_causal"] == 2 * n + n_prefix
    assert mod.LAUNCHES["flash_attention_causal_bwd"] - \
        before["flash_attention_causal_bwd"] == cfg.num_layers
    assert abs(float(gloss) - float(loss)) <= 1e-4 * abs(float(loss))
    for name, g in layers.flatten(grads).items():
        got = layers.flatten(ggrads)[name].cpu()
        scale = max(float(g.abs().max()), 1e-30)
        assert float((got - g).abs().max()) / scale <= 1e-3, name


@pytest.mark.parametrize("remat", ["none", "full", "dots", "save_attn"])
def test_remat_policies_launch_the_operators_alike(attn_cuda, remat):
    """The flash operator under each remat policy, on reduced
    smollm-360m: every policy that recomputes the mixer ("full",
    "dots" through ``_keep_dots``, which recomputes the operator as it
    recomputed the earlier ``autograd.Function``, and "save_attn", which
    checkpoints the mixer apart) launches 2 x layers forwards, "none"
    one a layer; each policy one backward a layer."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer
    from repro_torch.training.train_loop import value_and_grad
    cfg = dataclasses.replace(reduced_config("smollm-360m"), remat=remat)
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.randint(1, cfg.vocab_size, (2, 128), device="cuda",
                           dtype=torch.int32)
    before = dict(mod.LAUNCHES)
    value_and_grad(params, {"tokens": tokens, "labels": tokens}, cfg)
    torch.cuda.synchronize()
    n = cfg.num_layers
    assert mod.LAUNCHES["flash_attention_causal"] - \
        before["flash_attention_causal"] == (n if remat == "none" else 2 * n)
    assert mod.LAUNCHES["flash_attention_causal_bwd"] - \
        before["flash_attention_causal_bwd"] == n


# ---------------------------------------------------------------------------
# the scheduler and the baselines on the card against their CPU runs
# ---------------------------------------------------------------------------
def _svc_stream(seed, R, t, n):
    """Batches over 8 disjoint key stripes with a 3-batch burst on one
    stripe every 8 batches (``benchmarks/admission.py``'s mixed stream)."""
    from repro_torch.core.txn import make_batch
    rng = np.random.default_rng(seed)
    width = R // 8
    out, cold = [], 0
    for i in range(n):
        if i % 8 < 3:
            stripe = (i // 8) % 3
        else:
            stripe, cold = 3 + cold % 5, cold + 1
        lo = stripe * width
        recs = rng.integers(lo, lo + width, (t, 4))
        out.append(make_batch(recs, recs.copy(), np.zeros(t), np.zeros((t, 1)),
                              device="cpu"))
    return out


def _svc_run(device, batches, R):
    from repro_torch.core.carry import store_to_numpy
    from repro_torch.core.engine import BohmEngine
    from repro_torch.core.workloads import gen_scan_batch, make_ycsb
    from repro_torch.service import TxnService
    eng = BohmEngine(R, make_ycsb(payload_words=8, ops=4), device=device)
    svc = TxnService(eng, max_inflight=4, admission_window=16,
                     max_inflight_execs=4)
    tickets = []
    for i, b in enumerate(batches):
        tickets.append(svc.submit(b))
        if i == 5:
            pin = svc.begin_snapshot()
    reads = [svc.wait(t).read_vals.cpu() for t in tickets]
    svc.drain()
    scan = gen_scan_batch(np.random.default_rng(1), 64, R, ops=4,
                          device=device)
    vals, found, _ = svc.run_readonly_batch(scan, pin)
    return (reads, svc.dispatch_log, dict(svc.stats),
            store_to_numpy(eng.store), vals.cpu(), found.cpu())


def test_service_out_of_order_matches_cpu(cuda):
    """TxnService (out of order, chained execs) over an engine on the card
    equals the same service on the CPU: per-ticket reads, dispatch log,
    counters, store arrays and the pinned read-only batch; the reads went
    through the in-place resolve kernels."""
    R = 4096
    batches = _svc_stream(3, R, 64, 16)
    before = dict(mod.LAUNCHES)
    gpu = _svc_run("cuda", batches, R)
    torch.cuda.synchronize()
    assert mod.LAUNCHES["mvcc_resolve/rows"] > before["mvcc_resolve/rows"]
    assert mod.LAUNCHES["mvcc_resolve/windows"] == \
        before["mvcc_resolve/windows"]
    cpu = _svc_run("cpu", batches, R)
    for a, b in zip(gpu[0], cpu[0]):
        assert torch.equal(a, b)
    assert gpu[1] == cpu[1] and gpu[2] == cpu[2]
    assert gpu[2]["merged_batches"] > 0 and gpu[2]["hopped_batches"] > 0
    for k in cpu[3]:
        np.testing.assert_array_equal(gpu[3][k], cpu[3][k], err_msg=k)
    assert torch.equal(gpu[4], cpu[4]) and torch.equal(gpu[5], cpu[5])


@pytest.mark.parametrize("name", ["2pl", "occ", "si", "hekaton"])
def test_baseline_matches_cpu(cuda, name):
    """Each baseline protocol on the card equals its CPU run: base, reads
    and every stat, dtype included."""
    from repro_torch.core import baselines
    from repro_torch.core.workloads import gen_ycsb_batch, make_ycsb
    run = getattr(baselines, {"2pl": "run_2pl", "occ": "run_occ",
                              "si": "run_si", "hekaton": "run_hekaton"}[name])
    R = 65536
    batch = gen_ycsb_batch(np.random.default_rng(42), 512, R, theta=0.9,
                           mix="10rmw", device="cpu")
    wl = make_ycsb(payload_words=8)
    base = torch.zeros((R, 8), dtype=torch.int32)
    cpu = run(base, batch, wl, R)
    gpu = run(base.cuda(), batch.to("cuda"), wl, R)
    assert torch.equal(gpu[0].cpu(), cpu[0])
    assert torch.equal(gpu[1].cpu(), cpu[1])
    assert set(gpu[2]) == set(cpu[2])
    for k, v in cpu[2].items():
        assert gpu[2][k].dtype == v.dtype and gpu[2][k].is_cuda, k
        assert torch.equal(gpu[2][k].cpu(), v), k


# ---------------------------------------------------------------------------
# the protocol arena on the card against its CPU runs
# ---------------------------------------------------------------------------
def test_gauntlet_matches_cpu(cuda):
    """The standing gauntlet through all six adapters on the card gives
    the CPU's rows in every field, each as expected."""
    from repro_torch.arena import default_scenarios, run_gauntlet
    gpu = run_gauntlet(default_scenarios(device="cuda"), device="cuda")
    cpu = run_gauntlet(default_scenarios(device="cpu"), device="cpu")
    assert gpu == cpu
    assert all(r["as_expected"] for r in gpu)


def test_run_cell_matches_cpu(cuda):
    """One small ``run_cell`` (the scan cell: update batches with pinned
    scans) gives the CPU's rows apart from the wall-clock fields; Bohm's
    scans read through the in-place resolve kernels."""
    from repro_torch.arena import arena_matrix, make_protocols, run_cell
    from repro_torch.core.workloads import make_ycsb
    kw = dict(num_records=4096, batch_size=64, n_batches=2, seed=1)
    rows = {}
    before = dict(mod.LAUNCHES)
    for device in ("cuda", "cpu"):
        cell = next(c for c in arena_matrix(device=device, **kw)
                    if c.name == "scan-pinned-z0.9")
        protos = make_protocols(4096, make_ycsb(2, ops=10), device=device)
        rows[device] = [{k: v for k, v in r.items()
                         if k not in ("time_s", "txn_s")}
                        for r in run_cell(cell, protos, iters=1)]
        if device == "cuda":
            torch.cuda.synchronize()
            assert mod.LAUNCHES["mvcc_resolve/rows"] > \
                before["mvcc_resolve/rows"]
            assert mod.LAUNCHES["mvcc_resolve/windows"] == \
                before["mvcc_resolve/windows"]
    assert rows["cuda"] == rows["cpu"]
    assert all(r["verdict"] == "serial-equivalent" for r in rows["cpu"])


# ---------------------------------------------------------------------------
# the lifecycle auditor on the card
# ---------------------------------------------------------------------------
AUDIT_CONFIGS = {
    # saturating: a 2 x 2 pool under a held pin drops pinned history
    "dense": dict(ring_slots=2, spill_buckets=2, spill_slots=2),
    "dense-2-shards": dict(ring_slots=2, spill_buckets=2, spill_slots=2,
                           n_shards=2),
    # a few pages over one a record: allocation fails under the pin
    "paged": dict(ring_slots=4, paged=True, page_slots=2,
                  pages_per_shard=308, spill_slots=0),
}


def _audit_run(device, kw, audited, monkeypatch=None, R=300):
    """A hot zipfian stream with a pin held from batch 2 and sweeps after
    batches 4 and 6; returns the engine, reads, the pin, the pinned reads
    of every record, the store and the joins (``device.fence`` +
    ``torch.cuda.synchronize`` calls) it made."""
    import repro_torch.device
    from repro_torch.core import workloads as wl
    from repro_torch.core.carry import store_to_numpy
    from repro_torch.core.engine import BohmEngine
    from repro_torch.obs import LifecycleAuditor

    joins = {"n": 0}
    if monkeypatch is not None:
        real_fence, real_sync = repro_torch.device.fence, \
            torch.cuda.synchronize

        def fence(x):
            joins["n"] += 1
            return real_fence(x)

        def sync(*a, **k):
            joins["n"] += 1
            return real_sync(*a, **k)

        monkeypatch.setattr(repro_torch.device, "fence", fence)
        monkeypatch.setattr(torch.cuda, "synchronize", sync)
    aud = LifecycleAuditor(capacity=1 << 16, pending_cap=1 << 10,
                           per_record_cap=1 << 12) if audited else None
    eng = BohmEngine(R, wl.make_ycsb(payload_words=4, ops=4), device=device,
                     auditor=aud, **kw)
    rng = np.random.default_rng(5)
    reads = []
    for i in range(6):
        reads.append(eng.run_batch(wl.gen_ycsb_batch(
            rng, 64, R, theta=1.1, ops=4, device=device))[0].cpu())
        if i == 1:
            pin = eng.begin_snapshot()
        if i in (3, 5):
            eng.gc_sweep()
    vals, found = eng.snapshot_read(torch.arange(R), pin)
    out = (eng, reads, pin, vals.cpu(), found.cpu(),
           store_to_numpy(eng.store), joins["n"])
    if monkeypatch is not None:
        monkeypatch.undo()
    return out


@pytest.mark.parametrize("name", list(AUDIT_CONFIGS))
def test_audited_engine_equals_unaudited_on_card(cuda, monkeypatch, name):
    """An audited engine on the card gives the unaudited one's reads,
    pinned reads and store byte for byte, launches the same kernels the
    same number of times (the in-place forms only) and makes as many
    host joins."""
    kw = AUDIT_CONFIGS[name]
    runs = {}
    for audited in (False, True):
        mod.reset_launches()
        runs[audited] = _audit_run("cuda", kw, audited, monkeypatch)
        torch.cuda.synchronize()
        runs[audited] += (dict(mod.LAUNCHES),)
    off, on = runs[False], runs[True]
    for a, b in zip(off[1], on[1]):
        assert torch.equal(a, b)
    assert torch.equal(off[3], on[3]) and torch.equal(off[4], on[4])
    for k in off[5]:
        np.testing.assert_array_equal(off[5][k], on[5][k], err_msg=k)
    assert off[6] == on[6]
    assert off[7] == on[7]
    for form in ("mvcc_resolve", "mvcc_resolve_masked",
                 "mvcc_resolve_paged"):
        assert on[7][f"{form}/windows"] == 0
        assert on[7][f"{form}/rows"] == on[7][form]
    assert on[0].auditor.telescope()["balanced"]


@pytest.mark.parametrize("name", list(AUDIT_CONFIGS))
def test_every_miss_explained_on_card(cuda, name):
    """Every found=False at the held pin is explained by a drop event
    covering it, found reads resolve to a resident version, and the
    explanations, events, telescope and GC report equal the CPU run's;
    no sweep reclaimed a pinned version."""
    import dataclasses
    kw = AUDIT_CONFIGS[name]
    gpu = _audit_run("cuda", kw, True)
    cpu = _audit_run("cpu", kw, True)
    assert torch.equal(gpu[4], cpu[4]) and torch.equal(gpu[3], cpu[3])
    ga, ca = gpu[0].auditor, cpu[0].auditor
    assert [dataclasses.astuple(e) for e in ga.events()] == \
        [dataclasses.astuple(e) for e in ca.events()]
    assert ga.state_counts() == ca.state_counts()
    assert ga.telescope() == ca.telescope()
    assert ga.gc_report() == ca.gc_report()
    found, ts = gpu[4].numpy(), gpu[2].ts
    assert not found.all(), "the stream never saturated the store"
    for r in range(found.shape[0]):
        exp = ga.explain_read(r, ts)
        assert exp["found"] == bool(found[r])
        if found[r]:
            assert exp["reason"].startswith("resident_")
        else:
            assert exp["event"] is not None and exp["event"].covers(ts)
        want = ca.explain_read(r, ts)
        assert exp["reason"] == want["reason"]
    assert ga.telescope()["balanced"]
    assert ga.gc_report()["pin_stabbed_reclaims"] == 0


@pytest.mark.parametrize("name", list(AUDIT_CONFIGS))
def test_gc_sharded_audited_card_equals_cpu(cuda, name):
    """``gc_sharded_audited`` on the card returns the CPU's dict (every
    tensor on the card, int32 as on the CPU) and the same swept store,
    at the held pin and above it."""
    import dataclasses
    from repro_torch.core.carry import store_to_numpy
    from repro_torch.store import gc_sharded_audited
    kw = AUDIT_CONFIGS[name]
    gpu = _audit_run("cuda", kw, False)
    cpu = _audit_run("cpu", kw, False)
    for wm, pins in ((gpu[2].ts, [gpu[2].ts]), (gpu[0].current_ts(), [])):
        outs = []
        for eng in (gpu[0], cpu[0]):
            pin_ts = torch.tensor(pins or [2 ** 31 - 1], dtype=torch.int32,
                                  device=eng.device)
            v, n, audit = gc_sharded_audited(eng.store.versions, wm, pin_ts,
                                             event_cap=64)
            outs.append((v, n, audit, eng))
        (gv, gn, ga, ge), (cv, cn, ca, ce) = outs
        assert int(gn) == int(cn) and list(ga) == list(ca)
        for k in ca:
            assert ga[k].is_cuda and ga[k].dtype == ca[k].dtype, k
            assert torch.equal(ga[k].cpu(), ca[k]), k
        gs = store_to_numpy(dataclasses.replace(ge.store, versions=gv))
        cs = store_to_numpy(dataclasses.replace(ce.store, versions=cv))
        for k in cs:
            np.testing.assert_array_equal(gs[k], cs[k], err_msg=k)
    assert int(ca["gc_dead_total"]) > 0


# ---------------------------------------------------------------------------
# the paper's benchmark suites (benchmarks_torch/) on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card(monkeypatch, tmp_path):
    """Skips without a GPU; the suites' JSON twins go to ``tmp_path``.
    (``kernels.py`` calls the plain versions on CUDA tensors on purpose,
    so the ``cuda`` fixture's guard does not apply here.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from benchmarks_torch import common
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)


def _suite_rows(name, device, monkeypatch):
    import importlib
    suite = importlib.import_module(f"benchmarks_torch.{name}")
    if name == "microbench":
        monkeypatch.setattr(suite, "N_RECORDS", 65536)
        return suite.run(device=device)
    if name in ("spill", "paged", "pipeline"):
        return suite.run(quick=True, device=device)
    return suite.run(device=device)


@pytest.mark.parametrize("name", ["snapshot", "spill", "paged", "pipeline",
                                  "microbench", "kernels", "serving"])
def test_bench_suite_card_equals_cpu(card, monkeypatch, name):
    """A suite's rows on the card equal its CPU rows in every field that
    is not a wall time (``backend`` names the device); the resolve
    kernels launched in place only, except ``kernels.py``'s windows-form
    row."""
    from benchmarks_torch.common import row_mismatches
    mod.reset_launches()
    gpu = _suite_rows(name, "cuda", monkeypatch)
    torch.cuda.synchronize()
    launches = dict(mod.LAUNCHES)
    cpu = _suite_rows(name, "cpu", monkeypatch)
    assert not row_mismatches(cpu, gpu, skip=("backend",))
    if name != "kernels":
        for k in ("mvcc_resolve", "mvcc_resolve_masked",
                  "mvcc_resolve_paged"):
            assert launches[f"{k}/windows"] == 0, launches
    want = {"snapshot": "mvcc_resolve_masked", "paged":
            "mvcc_resolve_paged", "serving": "decode_attention",
            "kernels": "mvcc_resolve/windows"}.get(name)
    if want:
        assert launches[want] > 0, launches


def test_snapshot_pinned_scans_on_card(card):
    """The pinned YCSB cell at 65,536 records: every found scan read
    equals the state at the pin."""
    from benchmarks_torch import snapshot
    probe = {}
    row = snapshot.bench_cell("ycsb", True, np.random.default_rng(29),
                              65536, "cuda", probe=probe)
    assert row["scan_found_frac"] > 0
    for scan, vals, found in probe["scans"]:
        want = probe["at_pin"][scan.read_set.long()]
        assert torch.equal(vals[found], want[found])
