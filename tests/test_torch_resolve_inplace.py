"""The in-place forms of ``mvcc_resolve`` and ``mvcc_resolve_masked``
(the ring's rows and the spill pool's buckets read where they lie, the
primary level's result passed to the spill fall-through) against the
JAX reference's composition of gather, Pallas kernel (interpret mode)
and select, on the same numpy inputs.

Tolerance: exact. int32 sums are exact; float32 is compared with rtol=0
as well, since the rings and pools here are consistent (a record's
[begin, end) windows do not overlap), so at most one slot is selected
per read and no float sum is taken.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, fresh_ref_engine, np_, port_batch
from repro.core import workloads as ref_wl
from repro.kernels import ops as ref_ops
from repro.store import sharded as ref_sh
from repro.store import spill as ref_spill
from repro.store.ring import VersionRing as RefRing
from repro.store.ring import gather_windows as ref_gather_windows
from repro_torch.core import workloads as port_wl
from repro_torch.core.engine import BohmEngine
from repro_torch.kernels import ops
from repro_torch.store import sharded

INF = np.iinfo(np.int32).max


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _ring(rng, R, K, D, dtype):
    """A consistent ring: each row holds 0..K live versions with
    increasing begins, each ending where the next begins (the newest
    open), in slots rotated by a random head; empty slots INF / INF."""
    live = rng.integers(0, K + 1, R)
    begin = np.full((R, K), INF, np.int32)
    end = np.full((R, K), INF, np.int32)
    steps = np.cumsum(rng.integers(1, 20, (R, K)), axis=1)
    for r in range(R):
        n = live[r]
        b = (rng.integers(0, 30) + steps[r, :n]).astype(np.int32)
        e = np.append(b[1:], INF).astype(np.int32)
        slots = (rng.integers(0, K) + np.arange(n)) % K
        begin[r, slots], end[r, slots] = b, e
    data = rng.integers(-1000, 1000, (R, K, D)).astype(dtype)
    return begin, end, data


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("D", [1, 8, 33])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_rows_form_matches_gather_then_pallas(K, D, dtype):
    """``mvcc_resolve(..., rows=)`` on the CPU (its plain version) equals
    the reference's ``gather_windows`` + ``mvcc_resolve`` (Pallas
    interpret), with reads of rows outside [0, R) not found and zero."""
    rng = np.random.default_rng(100 * K + D)
    R, B = 37, 101
    begin, end, data = _ring(rng, R, K, D, dtype)
    rows = rng.integers(-3, R + 3, B).astype(np.int32)
    rows[:3] = [0, R - 1, R]
    ts = rng.integers(0, 200, B).astype(np.int32)
    ring = RefRing(*(jnp.asarray(a) for a in (begin, end, data)),
                   jnp.zeros((R,), jnp.int32))
    windows = ref_gather_windows(ring, jnp.asarray(np.clip(rows, 0, R - 1)))
    ref_v, ref_f = (np.asarray(x) for x in ref_ops.mvcc_resolve(
        *windows, jnp.asarray(ts), block_b=64, block_d=64, interpret=True))
    inside = (rows >= 0) & (rows < R)
    vals, found = ops.mvcc_resolve(*_t(begin, end, data, ts),
                                   rows=torch.from_numpy(rows))
    assert vals.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(found.numpy(), ref_f & inside)
    np.testing.assert_allclose(vals.numpy(),
                               np.where(inside[:, None], ref_v, 0),
                               rtol=0, atol=0)
    assert found[3:].any() and not found.numpy()[~inside].any()


def _spilled_store(seed):
    """A reference engine after a pinned, overflowing zipfian stream (2
    ring slots, a spill pool of 8 buckets x 4 slots): its single shard's
    ring and pool, and the pins' timestamps."""
    R = 96
    eng = fresh_ref_engine(R, "ycsb3x4",
                           lambda: ref_wl.make_ycsb(payload_words=3, ops=4),
                           ring_slots=2, spill_buckets=8, spill_slots=4)
    rng = np.random.default_rng(seed)
    pins = []
    for i in range(5):
        eng.run_batch(ref_wl.gen_ycsb_batch(rng, 32, R, theta=0.9, ops=4))
        if i in (0, 2):
            pins.append(eng.begin_snapshot().ts)
    st = eng.store.versions
    return R, ref_sh._ring0(st), ref_sh._take_spill(st, 0), pins, eng


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_masked_in_place_matches_reference_two_level(seed, dtype):
    """The pool read in place (bucket ``max(want, 0) % NB`` computed by
    the call), without a prior against the reference's bucket gather +
    ``mvcc_resolve_masked`` (Pallas interpret), and with the primary's
    result as its prior against the reference's ``_resolve_two_level``;
    the payloads cast to ``dtype`` on both sides."""
    R, ring, pool, pins, _ = _spilled_store(seed)
    ring = RefRing(ring.begin, ring.end, ring.payload.astype(dtype),
                   ring.head)
    pool = ref_spill.SpillPool(pool.begin, pool.end, pool.rec,
                               pool.payload.astype(dtype))
    want = np.concatenate([np.arange(R), [-1, 5, 5, R - 1]]).astype(np.int32)
    rows = np.maximum(want, 0)
    p_ring = _t(*(np_(x) for x in (ring.begin, ring.end, ring.payload)))
    p_pool = _t(*(np_(x) for x in (pool.begin, pool.end, pool.rec,
                                   pool.payload)))
    spill_only = prior_hits = 0
    for t in (*pins, pins[0] - 3, 1):
        ts = np.full(want.shape, t, np.int32)
        bkt = ref_spill.spill_buckets_for(jnp.asarray(want), 8)
        ref_s = ref_ops.mvcc_resolve_masked(
            pool.begin[bkt], pool.end[bkt], pool.rec[bkt], jnp.asarray(want),
            pool.payload[bkt], jnp.asarray(ts), block_b=64, block_d=64,
            interpret=True)
        b, e, r, d = p_pool
        port_s = ops.mvcc_resolve_masked(b, e, r, torch.from_numpy(want), d,
                                         torch.from_numpy(ts), in_place=True)
        for x, y in zip(ref_s, port_s):
            assert_same(x, y, f"masked in place, ts {t}")
        prim = ops.mvcc_resolve(*p_ring, torch.from_numpy(ts),
                                rows=torch.from_numpy(rows))
        port = ops.mvcc_resolve_masked(b, e, r, torch.from_numpy(want), d,
                                       torch.from_numpy(ts), in_place=True,
                                       prior=prim)
        ref = ref_sh._resolve_two_level(ring, pool, jnp.asarray(want),
                                        jnp.asarray(ts), True)
        for x, y in zip(ref, port):
            assert_same(x, y, f"two-level, ts {t}")
        spill_only += int((port_s[1] & ~prim[1]).sum())
        prior_hits += int(prim[1].sum())
    assert spill_only > 0 and prior_hits > 0     # both levels answered


def test_in_place_forms_check_their_inputs():
    z = torch.zeros((4, 2), dtype=torch.int32)
    d = torch.zeros((4, 2, 3), dtype=torch.int32)
    t = torch.zeros((6,), dtype=torch.int32)
    rows = torch.zeros((6,), dtype=torch.int32)
    prior = (torch.zeros((6, 3), dtype=torch.int32),
             torch.zeros((6,), dtype=torch.bool))
    before = dict(ops.LAUNCHES)
    v, f = ops.mvcc_resolve(z, z, d, t, rows=rows)
    assert v.shape == (6, 3) and f.shape == (6,)
    v, f = ops.mvcc_resolve_masked(z, z, z, t, d, t, in_place=True,
                                   prior=prior)
    assert v.shape == (6, 3) and f.shape == (6,)
    assert ops.LAUNCHES == before                # the CPU launches nothing
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.mvcc_resolve(z, z, d, t)             # windows: one per read
    with pytest.raises(ValueError, match="rows must be"):
        ops.mvcc_resolve(z, z, d, t, rows=rows[:5])
    with pytest.raises(TypeError):
        ops.mvcc_resolve(z, z, d, t, rows=rows.long())
    with pytest.raises(ValueError, match="at least one row"):
        ops.mvcc_resolve(z[:0], z[:0], d[:0], t, rows=rows)
    with pytest.raises(ValueError, match="in_place"):
        ops.mvcc_resolve_masked(z, z, z, t[:4], d, t[:4],
                                prior=(prior[0][:4], prior[1][:4]))
    with pytest.raises(ValueError, match="prior must be"):
        ops.mvcc_resolve_masked(z, z, z, t, d, t, in_place=True,
                                prior=(prior[0].float(), prior[1]))
    with pytest.raises(ValueError, match="prior must be"):
        ops.mvcc_resolve_masked(z, z, z, t, d, t, in_place=True,
                                prior=(prior[0], prior[1].int()))


@pytest.mark.parametrize("kw", [
    dict(ring_slots=2, spill_buckets=8, spill_slots=8),
    dict(ring_slots=2, spill_buckets=8, spill_slots=8, n_shards=2),
    dict(ring_slots=4, spill_buckets=8, spill_slots=8, paged=True,
         page_slots=2, pages_per_shard=160)],
    ids=["dense", "dense-2-shards", "paged"])
def test_read_path_calls_only_in_place_forms(monkeypatch, kw):
    """Every read of the engine (``snapshot_read``, ``run_readonly_batch``)
    reaches ``mvcc_resolve`` or ``mvcc_resolve_paged`` with ``rows=`` (the
    paged one with the slab's own table) and ``mvcc_resolve_masked`` in
    place with the primary's result as its prior: no window or table row
    is gathered on the read path. The reads still equal the reference
    engine's."""
    calls = []

    def spy(name, fn):
        def run(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return run

    for name in ("mvcc_resolve", "mvcc_resolve_masked",
                 "mvcc_resolve_paged"):
        monkeypatch.setattr(sharded.ops, name, spy(name,
                                                   getattr(ops, name)))
    R = 120
    ref = fresh_ref_engine(R, "ycsb2x4",
                           lambda: ref_wl.make_ycsb(payload_words=2, ops=4),
                           **kw)
    port = BohmEngine(R, port_wl.make_ycsb(payload_words=2, ops=4),
                      device="cpu", **kw)
    rng = np.random.default_rng(7)
    for i in range(4):
        batch = ref_wl.gen_ycsb_batch(rng, 40, R, theta=1.1, ops=4)
        ref.run_batch(batch)
        port.run_batch(port_batch(batch))
        if i == 0:
            r_pin, p_pin = ref.begin_snapshot(), port.begin_snapshot()
    recs = np.arange(R)
    for a, b in zip(ref.snapshot_read(recs, r_pin),
                    port.snapshot_read(recs, p_pin)):
        assert_same(a, b, "snapshot_read")
    scan = ref_wl.gen_scan_batch(np.random.default_rng(8), 16, R, ops=5,
                                 theta=1.1)
    for a, b in zip(ref.run_readonly_batch(scan, r_pin)[:2],
                    port.run_readonly_batch(port_batch(scan), p_pin)[:2]):
        assert_same(a, b, "run_readonly_batch")
    names = [n for n, _, _ in calls]
    primary = "mvcc_resolve_paged" if kw.get("paged") else "mvcc_resolve"
    assert names.count(primary) == names.count("mvcc_resolve_masked") > 0
    tables = [] if not kw.get("paged") else [
        port.store.versions.pages.page_table[s]
        for s in range(port.store.versions.n_shards)]
    for name, args, kwargs in calls:
        if name in ("mvcc_resolve", "mvcc_resolve_paged"):
            assert kwargs.get("rows") is not None
        if name == "mvcc_resolve_paged":      # the table itself, no copy
            assert any(args[0].data_ptr() == t.data_ptr() for t in tables)
        elif name == "mvcc_resolve_masked":
            assert kwargs.get("in_place") and kwargs.get("prior") is not None
