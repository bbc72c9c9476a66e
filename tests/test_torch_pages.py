"""The paged version store and adaptive K: the port (``device="cpu"``)
against the JAX reference on the same numpy inputs.

  1. ``mvcc_resolve_paged_plain`` (the CPU path and the CUDA kernel's
     oracle) equals the Pallas kernel in interpret mode — on the inputs of
     ``tests/test_pages.py`` (all-unmapped rows and the single-page
     degenerate case included) and on a shape sweep in int32 and float32;
  2. the store functions (``commit_paged`` with a saturating free list,
     ``gc_pages`` returning pages a ``k_eff`` shrink stranded,
     ``page_owner_index``, ``paged_occupancy``, the window gathers, the
     sharded helpers) equal the reference field by field;
  3. engine streams (zipfian θ=1.1, pins rolled every 2 batches, at most 2
     held, a ``gc_sweep`` at each pin) in paged fixed-K, paged adaptive
     (cumulative and EWMA pressure) and dense adaptive (quantum 1 and 2)
     configurations, and the reference's page grant/reclaim scenarios;
  4. inside the port: a paged engine equals a dense one with
     ``k_quantum=page_slots``;
  5. the ``BENCH_paged`` stream (``benchmarks/paged.py``) through both
     packages;
  6. a reference engine's paged state carried into a port engine;
  7. the API: paged and adaptive engines construct; ``commit_paged``'s
     audit taps raise.

Everything is compared byte for byte except the float32 gauges
``ring_occ_mean`` and ``found_frac`` (rtol 1e-6, as ``_torch_parity``
states).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_dicts_same, assert_same, dataclass_arrays,
                           fresh_ref_engine, np_, port_batch,
                           ref_store_arrays)
from benchmarks import paged as bench_paged
from benchmarks import spill as bench_spill
from repro.core import workloads as ref_wl
from repro.core.execute import execute_plan as ref_execute
from repro.core.plan import cc_plan as ref_cc_plan
from repro.core.txn import Workload as RefWorkload
from repro.core.txn import make_batch as ref_make_batch
from repro.kernels import ops as ref_ops
from repro.store import pages as ref_pages
from repro.store import sharded as ref_sh
from repro_torch.core import workloads as port_wl
from repro_torch.core.carry import store_from_reference, store_to_numpy
from repro_torch.core.engine import BohmEngine
from repro_torch.core.txn import Workload
from repro_torch.kernels import ops
from repro_torch.store import pages, sharded

R, T = 64, 32
INF = np.iinfo(np.int32).max


def _t(x):
    return torch.tensor(np_(x))


# ---------------------------------------------------------------------------
# 1. the plain paged resolve vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
def _slab(rng, P, S, D, dtype):
    """A consistent slab: every begin distinct (no ties), end > begin."""
    begin = rng.permutation(P * S * 2)[:P * S].reshape(P, S).astype(np.int32)
    end = begin + rng.integers(1, 30, (P, S)).astype(np.int32)
    data = rng.integers(-99, 99, (P, S, D)).astype(dtype)
    return begin, end, data


def _rows(rng, P, MaxP, B, unmapped=0.4):
    """Page rows without repeats within a row, some entries unmapped."""
    pt = np.stack([rng.permutation(P)[:MaxP] for _ in range(B)]).astype(
        np.int32)
    pt[rng.random((B, MaxP)) < unmapped] = -1
    return pt


def _both(pt, begin, end, data, ts):
    ref = ref_ops.mvcc_resolve_paged(pt, begin, end, data, ts,
                                     interpret=True)
    port = ops.mvcc_resolve_paged_plain(*(_t(a) for a in (pt, begin, end,
                                                          data, ts)))
    assert port[0].numpy().dtype == np_(ref[0]).dtype
    assert_same(ref[0], port[0], "vals")
    assert_same(ref[1], port[1], "found")
    return port


def test_paged_plain_matches_pallas_on_reference_inputs():
    """The inputs of ``test_pages.py::test_paged_resolve_kernel_matches_ref``
    (P=23, S=3, MaxP=4, B=37, D=5)."""
    rng = np.random.default_rng(3)
    P, S, MaxP, B, D = 23, 3, 4, 37, 5
    begin, end, data = _slab(rng, P, S, D, np.int32)
    pt = np.stack([rng.permutation(P)[:MaxP] for _ in range(B)]).astype(
        np.int32)
    pt[rng.random((B, MaxP)) < 0.4] = -1
    pt[[2, 11]] = -1                                # all-unmapped rows
    ts = rng.integers(0, 80, B).astype(np.int32)
    vals, found = _both(pt, begin, end, data, ts)
    assert found.any() and not found[[2, 11]].any()
    assert (vals[[2, 11]] == 0).all()
    # the CPU wrapper takes the plain version and launches nothing
    before = dict(ops.LAUNCHES)
    v2, f2 = ops.mvcc_resolve_paged(*(_t(a) for a in (pt, begin, end, data,
                                                      ts)))
    assert torch.equal(v2, vals) and torch.equal(f2, found)
    assert ops.LAUNCHES == before
    # a fully mapped single-page table degrades to the dense select over
    # that page's window
    pt1 = np.arange(B, dtype=np.int32)[:, None] % P
    v1, f1 = _both(pt1, begin, end, data, ts)
    vd, fd = ops.mvcc_resolve_plain(*(_t(a) for a in (
        begin[pt1[:, 0]], end[pt1[:, 0]], data[pt1[:, 0]], ts)))
    assert torch.equal(v1, vd) and torch.equal(f1, fd)


@pytest.mark.parametrize("P,S,MaxP,B,D", [(5, 1, 1, 1, 1), (64, 2, 8, 129, 8),
                                          (40, 4, 3, 70, 33),
                                          (300, 2, 6, 257, 3)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_paged_plain_matches_pallas_sweep(P, S, MaxP, B, D, dtype):
    rng = np.random.default_rng(P * 7 + S * 3 + MaxP + B)
    begin, end, data = _slab(rng, P, S, D, dtype)
    pt = _rows(rng, P, MaxP, B, unmapped=0.5)
    ts = rng.integers(0, 2 * P * S, B).astype(np.int32)
    _both(pt, begin, end, data, ts)


def test_paged_plain_sums_tied_begins_like_pallas():
    """Two mapped slots visible at the same largest begin: both versions
    sum (the Pallas tie rule), in int32."""
    begin = np.array([[3, 5], [5, 1], [7, 9]], np.int32)
    end = np.full((3, 2), INF, np.int32)
    data = (np.arange(12).reshape(3, 2, 2) + 1).astype(np.int32)
    pt = np.array([[0, 1, -1], [2, -1, 0]], np.int32)
    ts = np.array([6, 8], np.int32)
    vals, found = _both(pt, begin, end, data, ts)
    np.testing.assert_array_equal(vals[0].numpy(), data[0, 1] + data[1, 0])
    np.testing.assert_array_equal(vals[1].numpy(), data[2, 0])


@pytest.mark.parametrize("R,P,S,MaxP,B,D", [(1, 3, 1, 1, 4, 1),
                                            (37, 23, 3, 4, 60, 5),
                                            (50, 64, 2, 8, 129, 8),
                                            (20, 30, 1, 16, 40, 33)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_paged_rows_form_matches_pallas_on_clipped_table_rows(R, P, S, MaxP,
                                                               B, D, dtype):
    """``mvcc_resolve_paged(page_table, ..., rows=)`` on the CPU (its plain
    version) equals the Pallas kernel (interpret mode) over
    ``page_table[clip(rows, 0, R - 1)]`` for rows inside [0, R) and gives
    found = False and zeros outside; the table repeats pages within rows
    and holds ids >= P, unmapped on both sides."""
    rng = np.random.default_rng(R * 13 + P + S + MaxP + D)
    begin, end, data = _slab(rng, P, S, D, dtype)
    table = rng.integers(0, P, (R, MaxP)).astype(np.int32)
    table[rng.random((R, MaxP)) < 0.3] = -1
    table[rng.random((R, MaxP)) < 0.1] = P + 1
    rows = rng.integers(-3, R + 3, B).astype(np.int32)
    rows[:3] = [0, R - 1, R]
    ts = rng.integers(0, 2 * P * S, B).astype(np.int32)
    pt = table[np.clip(rows, 0, R - 1)]
    ref_v, ref_f = (np_(x) for x in ref_ops.mvcc_resolve_paged(
        pt, begin, end, data, ts, interpret=True))
    inside = (rows >= 0) & (rows < R)
    args = [_t(a) for a in (table, begin, end, data, ts)]
    vals, found = ops.mvcc_resolve_paged_plain(*args, rows=_t(rows))
    assert vals.numpy().dtype == ref_v.dtype
    assert_same(np.where(inside[:, None], ref_v, 0), vals, "vals")
    assert_same(ref_f & inside, found, "found")
    before = dict(ops.LAUNCHES)
    v2, f2 = ops.mvcc_resolve_paged(*args, rows=_t(rows))
    assert torch.equal(v2, vals) and torch.equal(f2, found)
    assert ops.LAUNCHES == before                # the CPU launches nothing
    assert found[inside].any() or not ref_f.any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "payload_dtype", "rank"])
def test_paged_wrapper_rejects_bad_inputs(bad):
    pt = torch.zeros((4, 2), dtype=torch.int32)
    begin = torch.zeros((5, 3), dtype=torch.int32)
    end = torch.zeros((5, 3), dtype=torch.int32)
    data = torch.zeros((5, 3, 2), dtype=torch.int32)
    ts = torch.zeros((4,), dtype=torch.int32)
    if bad == "dtype":
        pt = pt.long()
    elif bad == "shape":
        end = end[:4]
    elif bad == "payload_dtype":
        data = data.double()
    else:
        begin = begin[None]
    with pytest.raises((TypeError, ValueError)):
        ops.mvcc_resolve_paged(pt, begin, end, data, ts)
    # the rows form: rows [B] int32 into a table of at least one row
    table = torch.zeros((4, 2), dtype=torch.int32)
    rows = torch.zeros((4,), dtype=torch.int32)
    rows = {"dtype": rows.long(), "shape": rows[:3]}.get(bad, rows)
    with pytest.raises((TypeError, ValueError)):
        ops.mvcc_resolve_paged(table, begin, end, data, ts, rows=rows)


# ---------------------------------------------------------------------------
# 2. store functions vs the reference
# ---------------------------------------------------------------------------
def _paged_state(seed, pages_per_shard=256, page_slots=2, ring_slots=4,
                 k_max=8, spill=(16, 16)):
    """A reference paged engine after a pinned, overflowing zipfian
    stream with adaptive sweeps, plus the next batch's plan and payloads."""
    eng = fresh_ref_engine(
        R, "ycsb2x4", lambda: ref_wl.make_ycsb(payload_words=2, ops=4),
        ring_slots=ring_slots, adaptive_k=True, k_max=k_max, paged=True,
        page_slots=page_slots, pages_per_shard=pages_per_shard,
        spill_buckets=spill[0], spill_slots=spill[1])
    rng = np.random.default_rng(seed)
    for i in range(6):
        eng.run_batch(ref_wl.gen_ycsb_batch(rng, T, R, theta=1.1, ops=4))
        if i in (1, 3):
            eng.begin_snapshot()
            eng.gc_sweep()
    batch = ref_wl.gen_ycsb_batch(rng, T, R, theta=1.1, ops=4)
    plan = ref_cc_plan(batch, eng.store.ts_counter)
    w_data, _, _ = ref_execute(plan, batch, eng.store, eng.workload)
    return eng, plan, w_data


def _slab0(store):
    p = store.versions.pages
    fields = (p.begin[0], p.end[0], p.payload[0], p.page_table[0], p.head[0])
    return (ref_pages.PageSlab(*fields),
            pages.PageSlab(*(_t(x) for x in fields)))


def _commit_both(eng, plan, w_data, ref_slab, port_slab, k_eff):
    lo = int(plan.ts_base)
    wm, pins = eng.watermark(), eng.pin_array()
    args = (plan.w_rec, plan.w_key, plan.w_valid, plan.w_begin_ts,
            plan.w_end_ts, w_data)
    ref_out, ref_m = ref_pages.commit_paged(
        ref_slab, *args, wm, ts_window=(lo, lo + T),
        k_eff=jnp.asarray(k_eff), pin_ts=pins, with_evictees=True)
    port_args = [_t(a) for a in args]
    port_args[1] = port_args[1].to(torch.int64)            # uint32 -> int64
    port_out, port_m = pages.commit_paged(
        port_slab, *port_args, wm, ts_window=(lo, lo + T), k_eff=_t(k_eff),
        pin_ts=_t(pins), with_evictees=True)
    assert_dicts_same(dataclass_arrays(ref_out), dataclass_arrays(port_out),
                      "slab")
    assert_dicts_same(ref_m, port_m, "commit metrics")
    return ref_out, port_out, port_m


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_paged_matches_reference(seed):
    eng, plan, w_data = _paged_state(seed)
    ref_slab, port_slab = _slab0(eng.store)
    rng = np.random.default_rng(seed + 20)
    k_eff = 2 * rng.integers(1, 5, R).astype(np.int32)   # MaxP * S = 8
    _, _, m = _commit_both(eng, plan, w_data, ref_slab, port_slab, k_eff)
    assert int(m["paged_pages_allocated"]) > 0
    assert int(m["evict_valid"].sum()) > 0               # spill has work
    # without a window or pins: the bare-slab liveness floor
    ref_out, ref_m = ref_pages.commit_paged(
        ref_slab, plan.w_rec, plan.w_key, plan.w_valid, plan.w_begin_ts,
        plan.w_end_ts, w_data, eng.watermark())
    port_out, port_m = pages.commit_paged(
        port_slab, _t(plan.w_rec), _t(plan.w_key).to(torch.int64),
        _t(plan.w_valid), _t(plan.w_begin_ts), _t(plan.w_end_ts),
        _t(w_data), eng.watermark())
    assert_dicts_same(dataclass_arrays(ref_out), dataclass_arrays(port_out),
                      "bare slab")
    assert_dicts_same(ref_m, port_m, "bare metrics")


def test_commit_paged_exhausted_free_list_matches_reference():
    """A slab with two spare pages: most page requests fail and the
    unplaceable versions are dropped and counted, identically."""
    eng, plan, w_data = _paged_state(2, pages_per_shard=R + 2,
                                     page_slots=1, ring_slots=4, k_max=4)
    ref_slab, port_slab = _slab0(eng.store)
    _, port_out, m = _commit_both(eng, plan, w_data, ref_slab, port_slab,
                                  np.full(R, 4, np.int32))
    assert int(m["paged_alloc_failed"]) > 0
    assert int(m["paged_pages_free"]) == 0
    assert int(pages.free_page_count(port_out)) == 0


def test_gc_pages_returns_stranded_pages_like_reference():
    """Shrink every record's capacity to one page: at a watermark above
    every closed version, drained pages beyond the first are returned to
    the free list — the same pages on both sides."""
    eng, _, _ = _paged_state(3)
    ref_slab, port_slab = _slab0(eng.store)
    k_small = np.full(R, 2, np.int32)                     # one page each
    wm = int(eng.store.ts_counter)
    ref_out, ref_n = ref_pages.gc_pages(ref_slab, wm, jnp.asarray(k_small))
    port_out, port_n = pages.gc_pages(port_slab, wm, _t(k_small))
    assert int(ref_n) == int(port_n) > 0
    assert_dicts_same(dataclass_arrays(ref_out), dataclass_arrays(port_out),
                      "gc_pages")
    assert int(pages.mapped_page_count(port_out)) < int(
        pages.mapped_page_count(port_slab))              # pages returned
    # at the pinned watermark nothing is stranded yet, still identical
    ref_out, _ = ref_pages.gc_pages(ref_slab, eng.watermark(),
                                    jnp.asarray(k_small))
    port_out, _ = pages.gc_pages(port_slab, eng.watermark(), _t(k_small))
    assert_dicts_same(dataclass_arrays(ref_out), dataclass_arrays(port_out),
                      "gc_pages at the pin")


def test_page_helpers_match_reference():
    eng, _, _ = _paged_state(4)
    ref_slab, port_slab = _slab0(eng.store)
    for a, b in zip(ref_pages.page_owner_index(ref_slab.page_table,
                                               ref_slab.num_pages),
                    pages.page_owner_index(port_slab.page_table,
                                           port_slab.num_pages)):
        assert_same(a, b, "page_owner_index")
    assert_same(ref_pages.paged_occupancy(ref_slab),
                pages.paged_occupancy(port_slab), "paged_occupancy")
    for fn in ("mapped_page_count", "free_page_count"):
        assert int(getattr(ref_pages, fn)(ref_slab)) == int(
            getattr(pages, fn)(port_slab)), fn
    np.testing.assert_allclose(
        float(pages.slab_fill_fraction(port_slab)),
        float(ref_pages.slab_fill_fraction(ref_slab)), rtol=1e-6)
    recs = np.array([0, 5, -1, R - 1, 17, 3, 3], np.int32)
    for a, b in zip(ref_pages.gather_windows_paged(ref_slab, recs),
                    pages.gather_windows_paged(port_slab, _t(recs))):
        assert_same(a, b, "gather_windows_paged")
    rng = np.random.default_rng(1)
    base = rng.integers(-9, 9, (R, 3)).astype(np.int32)
    base_ts = rng.integers(0, 5, R).astype(np.int32)
    real = rng.random(R) < 0.8
    assert_dicts_same(
        dataclass_arrays(ref_pages.init_page_slab(jnp.asarray(base), base_ts,
                                                  real, R + 9, 2, 3)),
        dataclass_arrays(pages.init_page_slab(_t(base), _t(base_ts),
                                              _t(real), R + 9, 2, 3)),
        "init_page_slab")
    with pytest.raises(ValueError):
        pages.init_page_slab(_t(base), _t(base_ts), _t(real), R - 1, 2, 3)


def test_sharded_paged_helpers_match_reference():
    eng, _, _ = _paged_state(5)
    st = eng.store
    port = store_from_reference(ref_store_arrays(st), "cpu").versions
    assert port.paged and port.num_slots == st.versions.num_slots == 8
    assert_same(ref_sh.store_occupancy(st.versions),
                sharded.store_occupancy(port), "store_occupancy")
    assert_dicts_same(ref_sh.store_health(st.versions),
                      sharded.store_health(port), "store_health",
                      rtol_keys=("slab_fill", "spill_fill"))
    recs = np.array([0, 9, -1, R - 1, 17], np.int32)
    for a, b in zip(ref_sh.gather_windows_sharded(st.versions, recs),
                    sharded.gather_windows_sharded(port, _t(recs))):
        assert_same(a, b, "gather_windows_sharded")
    ts = np.full(len(recs), eng.watermark(), np.int32)
    for a, b in zip(ref_sh.resolve_sharded(st.versions, recs, ts,
                                           interpret=True),
                    sharded.resolve_sharded(port, _t(recs), _t(ts))):
        assert_same(a, b, "resolve_sharded")
    wm = int(st.ts_counter)
    ref_v, ref_n = ref_sh.gc_sharded(st.versions, jnp.int32(wm))
    port_v, port_n = sharded.gc_sharded(port, wm)
    assert int(ref_n) == int(port_n)
    assert_dicts_same(dataclass_arrays(ref_v.pages),
                      dataclass_arrays(port_v.pages), "gc pages")
    assert_dicts_same(dataclass_arrays(ref_v.spill),
                      dataclass_arrays(port_v.spill), "gc spill")
    with pytest.raises(ValueError, match="paged"):
        sharded.unshard(port)
    # the dense store: unshard and store_health
    dense = fresh_ref_engine(R, "ycsb2x4",
                             lambda: ref_wl.make_ycsb(payload_words=2,
                                                      ops=4))
    dense.run_batch(ref_wl.gen_ycsb_batch(np.random.default_rng(6), T, R,
                                          theta=1.1, ops=4))
    port_d = store_from_reference(ref_store_arrays(dense.store),
                                  "cpu").versions
    assert_dicts_same(dataclass_arrays(ref_sh.unshard(dense.store.versions)),
                      dataclass_arrays(sharded.unshard(port_d)), "unshard")
    assert_dicts_same(ref_sh.store_health(dense.store.versions),
                      sharded.store_health(port_d), "dense store_health",
                      rtol_keys=("spill_fill",))


# ---------------------------------------------------------------------------
# 3. engine parity
# ---------------------------------------------------------------------------
BASE_KW = dict(ring_slots=4, spill_buckets=16, spill_slots=16)
CONFIGS = {
    "paged_fixed": dict(BASE_KW, paged=True, page_slots=2,
                        pages_per_shard=256),
    "paged_adaptive": dict(BASE_KW, adaptive_k=True, k_max=8, paged=True,
                           page_slots=2, pages_per_shard=256),
    "paged_adaptive_decay": dict(BASE_KW, adaptive_k=True, k_max=8,
                                 paged=True, page_slots=2,
                                 pages_per_shard=256, pressure_decay=1.0),
    "dense_adaptive_q1": dict(BASE_KW, adaptive_k=True, k_max=8),
    "dense_adaptive_q2": dict(BASE_KW, adaptive_k=True, k_max=8,
                              k_quantum=2),
}


def _pair(name, kw, make_ref, make_port, n=R):
    ref = fresh_ref_engine(n, name, make_ref, **kw)
    return ref, BohmEngine(n, make_port(), device="cpu", **kw)


def _counters(eng):
    return {k: v for k, v in eng.metrics.snapshot().items()
            if k.startswith("engine/")}


def _check_state(ref, port, msg):
    assert_dicts_same(ref_store_arrays(ref.store),
                      store_to_numpy(port.store), f"{msg}: store")
    assert_same(ref.k_by_record(), port.k_by_record(), f"{msg}: k_eff")
    assert ref.storage_stats() == port.storage_stats(), msg
    assert ref.overflow_stats() == port.overflow_stats(), msg
    assert ref.spill_stats() == port.spill_stats(), msg
    assert_dicts_same(_counters(ref), _counters(port), f"{msg}: counters")


def _check_reads(ref, port, pins, scan, msg, n=R):
    recs = np.arange(n)
    for r_pin, p_pin in pins:
        for a, b in zip(ref.snapshot_read(recs, r_pin),
                        port.snapshot_read(recs, p_pin)):
            assert_same(a, b, f"{msg}: snapshot_read@{r_pin.ts}")
        r_v, r_f, r_m = ref.run_readonly_batch(scan, r_pin)
        p_v, p_f, p_m = port.run_readonly_batch(port_batch(scan), p_pin)
        assert_same(r_v, p_v, f"{msg}: readonly vals")
        assert_same(r_f, p_f, f"{msg}: readonly found")
        assert_dicts_same(r_m, p_m, f"{msg}: readonly metrics")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_parity(config):
    kw = CONFIGS[config]
    ref, port = _pair("ycsb2x4", kw,
                      lambda: ref_wl.make_ycsb(payload_words=2, ops=4),
                      lambda: port_wl.make_ycsb(payload_words=2, ops=4))
    rng = np.random.default_rng(11)
    scan = ref_wl.gen_scan_batch(np.random.default_rng(12), 16, R, ops=4)
    pins = []
    for i in range(8):
        batch = ref_wl.gen_ycsb_batch(rng, T, R, theta=1.1, ops=4)
        r_vals, r_m = ref.run_batch(batch)
        p_vals, p_m = port.run_batch(port_batch(batch))
        assert_same(r_vals, p_vals, f"{config} batch {i}: reads")
        assert_dicts_same(r_m, p_m, f"{config} batch {i}")
        assert_dicts_same(ref_store_arrays(ref.store),
                          store_to_numpy(port.store), f"{config} batch {i}")
        if i % 2 == 1:
            pins.append((ref.begin_snapshot(), port.begin_snapshot()))
            while len(pins) > 2:
                r_pin, p_pin = pins.pop(0)
                ref.release_snapshot(r_pin)
                port.release_snapshot(p_pin)
            _check_reads(ref, port, pins, scan, f"{config} {i} before gc")
            assert ref.gc_sweep() == port.gc_sweep()
            _check_state(ref, port, f"{config} sweep {i}")
            _check_reads(ref, port, pins, scan, f"{config} {i} after gc")
    assert int(np_(port.overflow_by_record()).sum()) > 0  # it overflowed
    if kw.get("adaptive_k"):
        assert port.metrics.get("engine/k_slots_granted", 0) > 0
    assert ref.gc_sweep() == port.gc_sweep()             # idempotent sweep
    _check_state(ref, port, f"{config} second sweep")


def _hot_workloads():
    def ref_bump(vals, args):
        return vals.at[..., 0].add(1), jnp.zeros((), bool)

    def port_bump(vals, args):
        out = vals.clone()
        out[..., 0] += 1
        return out, torch.zeros(vals.shape[0], dtype=torch.bool)

    return (lambda: RefWorkload(name="hot", n_read=1, n_write=1,
                                payload_words=1, branches=(ref_bump,)),
            lambda: Workload(name="hot", n_read=1, n_write=1,
                             payload_words=1, branches=(port_bump,)))


@pytest.mark.parametrize("decay", [1.0, None])
def test_hotset_migration_scenarios_parity(decay):
    """``test_pages.py``'s grant-then-reclaim scenario (EWMA pressure:
    the old hot record's pages return to the free list and fund the new
    one) and its counterfactual (cumulative pressure holds the peak grant
    forever), run through both engines side by side."""
    make_ref, make_port = _hot_workloads()
    kw = dict(ring_slots=4, adaptive_k=True, k_max=12, paged=True,
              page_slots=2, pages_per_shard=12, pressure_decay=decay,
              spill_buckets=4, spill_slots=8)
    ref, port = _pair("hot", kw, make_ref, make_port, n=4)
    assert port.storage_stats()["pages_mapped"] == 4
    for rec, n in ((0, 4), (1, 10)):
        for _ in range(n):
            col = np.full((8, 1), rec)
            batch = ref_make_batch(col, col.copy(), np.zeros(8),
                                   np.zeros((8, 1)))
            r_pin, p_pin = ref.begin_snapshot(), port.begin_snapshot()
            assert_same(ref.run_batch(batch)[0],
                        port.run_batch(port_batch(batch))[0], "reads")
            assert ref.gc_sweep() == port.gc_sweep()
            _check_state(ref, port, f"hot rec {rec}")
            ref.release_snapshot(r_pin)
            port.release_snapshot(p_pin)
    k = np_(port.k_by_record())
    if decay is None:
        assert k[0] > 4                   # cumulative: peak grant held
    else:
        assert k[0] <= 4 < k[1]           # released to the new hot set
        assert port.storage_stats()["pages_free"] > 0


# ---------------------------------------------------------------------------
# 4. inside the port: paged == dense with the page-quantized policy
# ---------------------------------------------------------------------------
def test_port_paged_equals_port_dense():
    wl = port_wl.make_ycsb(payload_words=2, ops=4)
    kw = dict(ring_slots=4, spill_buckets=16, spill_slots=16,
              adaptive_k=True, k_max=8, device="cpu")
    dense = BohmEngine(R, wl, k_quantum=2, **kw)
    paged = BohmEngine(R, wl, paged=True, page_slots=2, pages_per_shard=256,
                       **kw)
    rng = np.random.default_rng(11)
    pins = []
    for i in range(8):
        batch = port_wl.gen_ycsb_batch(rng, T, R, theta=1.1, ops=4,
                                       device="cpu")
        assert torch.equal(dense.run_batch(batch)[0],
                           paged.run_batch(batch)[0])
        if i % 2 == 1:
            pins.append((dense.begin_snapshot(), paged.begin_snapshot()))
            while len(pins) > 2:
                d_pin, p_pin = pins.pop(0)
                dense.release_snapshot(d_pin)
                paged.release_snapshot(p_pin)
            dense.gc_sweep()
            paged.gc_sweep()
            assert torch.equal(dense.k_by_record(), paged.k_by_record())
    assert paged.storage_stats()["alloc_failed"] == 0
    recs = torch.arange(R)
    for d_pin, p_pin in pins:
        for a, b in zip(dense.snapshot_read(recs, d_pin),
                        paged.snapshot_read(recs, p_pin)):
            assert torch.equal(a, b)
    for a, b in zip(dataclass_arrays(dense.store.versions.spill).values(),
                    dataclass_arrays(paged.store.versions.spill).values()):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(dense.overflow_by_record(),
                       paged.overflow_by_record())
    assert int(paged.overflow_by_record().sum()) > 0
    assert torch.equal(dense.store.base, paged.store.base)


# ---------------------------------------------------------------------------
# 5. the BENCH_paged stream through both packages
# ---------------------------------------------------------------------------
def _port_stream(eng, batches):
    """``benchmarks/spill.py::_run_stream`` on the port: updates, a pin
    every PIN_EVERY batches (at most PINS_HELD held), a sweep at each."""
    pins = []
    for i, batch in enumerate(batches):
        eng.run_batch(batch)
        if (i + 1) % bench_spill.PIN_EVERY == 0:
            pins.append(eng.begin_snapshot())
            while len(pins) > bench_spill.PINS_HELD:
                eng.release_snapshot(pins.pop(0))
            eng.gc_sweep()
    return pins


def _found_rate(eng, pins):
    probe = np.arange(bench_spill.HOT_N + bench_spill.COLD_N)
    return float(np.concatenate([np_(eng.snapshot_read(probe, p)[1])
                                 for p in pins]).mean())


def test_bench_paged_stream_matches_reference():
    """The ``dense_kmax`` and ``paged`` configurations of
    ``benchmarks/paged.py`` on its stream (``_hotset_batch``,
    ``default_rng(67)``, 16 batches), one untimed pass each. The found
    rates are also compared with ``BENCH_paged.json`` (0.9565 for both,
    197 paged kwords): those numbers came from older code on JAX 0.4.37,
    so they are printed, not asserted."""
    rng = np.random.default_rng(67)
    batches = [bench_spill._hotset_batch(rng)
               for _ in range(bench_spill.N_BATCHES)]
    n = bench_spill.N_RECORDS
    configs = dict(bench_paged.CONFIGS)
    for name in ("dense_kmax", "paged"):
        kw = configs[name]
        ref = fresh_ref_engine(
            n, "bench", lambda: ref_wl.make_ycsb(payload_words=2,
                                                 ops=bench_spill.OPS), **kw)
        port = BohmEngine(n, port_wl.make_ycsb(payload_words=2,
                                               ops=bench_spill.OPS),
                          device="cpu", **kw)
        r_pins = bench_spill._run_stream(ref, batches)
        p_pins = _port_stream(port, [port_batch(b) for b in batches])
        r_found, p_found = _found_rate(ref, r_pins), _found_rate(port,
                                                                 p_pins)
        assert r_found == p_found, name
        assert ref.storage_stats() == port.storage_stats(), name
        assert_same(ref.k_by_record(), port.k_by_record(), name)
        print(f"BENCH_paged {name}: found_rate {p_found:.4f} (JSON 0.9565), "
              f"phys_kwords "
              f"{round(port.storage_stats()['physical_version_words'] / 1e3)}")


# ---------------------------------------------------------------------------
# 6. carried state
# ---------------------------------------------------------------------------
def test_paged_state_carried_from_reference():
    """A reference paged engine's state (store, next ts, two pins) loads
    into a port engine; reads at the carried pins, ``storage_stats()`` and
    two further fixed-K batches are equal."""
    kw = CONFIGS["paged_fixed"]
    ref, port = _pair("ycsb2x4", kw,
                      lambda: ref_wl.make_ycsb(payload_words=2, ops=4),
                      lambda: port_wl.make_ycsb(payload_words=2, ops=4))
    rng = np.random.default_rng(21)
    batches = [ref_wl.gen_ycsb_batch(rng, T, R, theta=1.1, ops=4)
               for _ in range(6)]
    r_pins = []
    for i, batch in enumerate(batches[:4]):
        ref.run_batch(batch)
        if i in (1, 2):
            r_pins.append(ref.begin_snapshot())
    p_pins = port.load_state(ref_store_arrays(ref.store), ref._ts_next,
                             pins=[p.ts for p in r_pins])
    pins = list(zip(r_pins, p_pins))
    scan = ref_wl.gen_scan_batch(np.random.default_rng(22), 16, R, ops=4)
    _check_reads(ref, port, pins, scan, "carried")
    assert ref.storage_stats() == port.storage_stats()
    for i, batch in enumerate(batches[4:]):
        r_vals, r_m = ref.run_batch(batch)
        p_vals, p_m = port.run_batch(port_batch(batch))
        assert_same(r_vals, p_vals, f"carried batch {i}")
        assert_dicts_same(r_m, p_m, f"carried batch {i}")
    assert_dicts_same(ref_store_arrays(ref.store),
                      store_to_numpy(port.store), "carried store")
    _check_reads(ref, port, pins, scan, "carried, 2 batches on")
    assert ref.gc_sweep() == port.gc_sweep()
    assert ref.storage_stats() == port.storage_stats()
    # a dense state does not fit a paged engine, nor the reverse
    with pytest.raises(ValueError, match="configuration"):
        BohmEngine(R, port_wl.make_ycsb(payload_words=2, ops=4),
                   device="cpu", **BASE_KW).load_state(
            ref_store_arrays(ref.store), ref._ts_next)


# ---------------------------------------------------------------------------
# 7. API rules
# ---------------------------------------------------------------------------
def test_paged_and_adaptive_engines_construct_and_validate():
    wl = port_wl.make_ycsb(payload_words=2, ops=4)
    eng = BohmEngine(16, wl, paged=True, adaptive_k=True, device="cpu")
    assert eng.store.versions.paged and eng.k_max == 8
    assert eng.k_quantum == eng.page_slots == 4
    assert eng.pages_per_shard == 16                 # ceil(4 / 4) each
    assert BohmEngine(16, wl, adaptive_k=True, device="cpu").k_quantum == 1
    for bad in (dict(k_max=2), dict(k_min=0), dict(k_min=5),
                dict(adaptive_k=True, paged=True, page_slots=3)):
        with pytest.raises(ValueError):
            BohmEngine(16, wl, device="cpu", **bad)
    slab = pages.init_page_slab(torch.zeros((4, 1), dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32),
                                torch.ones(4, dtype=torch.bool), 8, 2, 2)
    # the lifecycle tap: [3N] audit arrays (insert / victim / drop), all
    # masked for an invalid write, and the committed count
    z = torch.zeros(1, dtype=torch.int32)
    _, m = pages.commit_paged(slab, z, z.long(), z.bool(), z, z,
                              torch.zeros((1, 1), dtype=torch.int32), 1,
                              with_audit=True)
    assert m["audit_state"].shape == (3,) and int(m["ring_committed"]) == 0
    assert not m["audit_state"].any()
