"""Port vs reference: the CC plan, the store's commit/spill/GC steps and
the workload generators, all byte-for-byte on the same numpy inputs.

``Plan.w_key`` is uint32 in the reference and int64 in the port (same
values, same order); it is compared after a cast. Everything else is
int32/bool on both sides and must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_dicts_same, dataclass_arrays,
                           fresh_ref_engine, np_, port_batch,
                           ref_store_arrays)
from repro.core import workloads as ref_wl
from repro.core.execute import execute_plan as ref_execute
from repro.core.plan import cc_plan as ref_cc_plan
from repro.core.txn import make_batch as ref_make_batch
from repro.store import ring as ref_ring
from repro.store import sharded as ref_sh
from repro.store import spill as ref_spill
from repro.store.ring import VersionRing as RefRing
from repro.store.ring import commit_versions as ref_commit_versions
from repro.store.sharded import gc_sharded as ref_gc_sharded
from repro.store.spill import SpillPool as RefPool
from repro.store.spill import spill_commit as ref_spill_commit
from repro_torch.core import workloads as port_wl
from repro_torch.core.carry import store_from_reference, store_to_numpy
from repro_torch.core.plan import cc_plan
from repro_torch.store import ring, sharded, spill
from repro_torch.store.ring import VersionRing, commit_versions
from repro_torch.store.sharded import gc_sharded
from repro_torch.store.spill import SpillPool, spill_commit

R, T = 96, 32


def _stream(kind: str, rng):
    if kind == "smallbank":
        return ref_wl.gen_smallbank_batch(rng, T, R // 2)
    if kind == "dup_write":
        # txn 1 names record 5 twice; later columns must supersede
        reads = np.array([[5, 6, -1], [5, 7, 5], [5, -1, -1], [7, 5, 6]])
        return ref_make_batch(reads, reads.copy(), np.zeros(4),
                              np.zeros((4, 1)))
    theta, mix = kind.split("/")
    return ref_wl.gen_ycsb_batch(rng, T, R, theta=float(theta), mix=mix,
                                 ops=6)


STREAMS = ["0.0/10rmw", "0.0/2rmw8r", "0.9/10rmw", "0.9/2rmw8r",
           "smallbank", "dup_write"]


@pytest.mark.parametrize("kind", STREAMS)
def test_cc_plan_matches_reference_field_by_field(kind):
    rng = np.random.default_rng(STREAMS.index(kind))
    batch = _stream(kind, rng)
    ref = dataclass_arrays(ref_cc_plan(batch, jnp.int32(17)))
    port = dataclass_arrays(cc_plan(port_batch(batch), 17))
    assert ref["w_key"].dtype == np.uint32
    assert port["w_key"].dtype == np.int64
    ref["w_key"] = ref["w_key"].astype(np.int64)
    assert_dicts_same(ref, port, kind)


def _engine_state(seed: int, buckets: int = 8, slots: int = 4):
    """A reference engine after a pinned, overflowing zipfian stream, plus
    the next batch's plan and produced payloads."""
    eng = fresh_ref_engine(R, "ycsb3x4",
                           lambda: ref_wl.make_ycsb(payload_words=3, ops=4),
                           ring_slots=2, spill_buckets=buckets,
                           spill_slots=slots)
    wl = eng.workload
    rng = np.random.default_rng(seed)
    for i in range(4):
        eng.run_batch(ref_wl.gen_ycsb_batch(rng, T, R, theta=0.9, ops=4))
        if i in (0, 2):
            eng.begin_snapshot()
    batch = ref_wl.gen_ycsb_batch(rng, T, R, theta=0.9, ops=4)
    plan = ref_cc_plan(batch, eng.store.ts_counter)
    w_data, _, _ = ref_execute(plan, batch, eng.store, wl)
    return eng, plan, w_data


def _t(x):
    return torch.tensor(np_(x))


@pytest.mark.parametrize("seed,pool", [(0, (8, 4)), (1, (8, 4)),
                                       (2, (2, 2))])
def test_commit_spill_gc_byte_equal_with_pins(seed, pool):
    """(2, 2) is a saturated pool: placement must pick victims, pinned
    history last."""
    eng, plan, w_data = _engine_state(seed, *pool)
    st = eng.store
    r = st.versions.rings
    ring0 = (r.begin[0], r.end[0], r.payload[0], r.head[0])
    ref_ring = RefRing(*ring0)
    port_ring = VersionRing(*(_t(x) for x in ring0))
    assert (port_ring.num_slots, port_ring.num_records) == \
        (ref_ring.num_slots, ref_ring.num_records) == (2, R)
    rng = np.random.default_rng(seed + 10)
    k_eff = rng.integers(1, 3, R).astype(np.int32)        # K = 2 physical
    pins = eng.pin_array()
    assert int(np.sum(np_(pins) < 2 ** 31 - 1)) == 2
    lo = int(plan.ts_base)
    wm = eng.watermark()
    args = (plan.w_rec, plan.w_key, plan.w_valid, plan.w_begin_ts,
            plan.w_end_ts, w_data)

    ref_out, ref_m = ref_commit_versions(
        ref_ring, *args, wm, ts_window=(lo, lo + T),
        k_eff=jnp.asarray(k_eff), pin_ts=pins, with_evictees=True)
    port_args = [_t(a) for a in args]
    port_args[1] = port_args[1].to(torch.int64)            # uint32 -> int64
    port_out, port_m = commit_versions(
        port_ring, *port_args, wm, ts_window=(lo, lo + T),
        k_eff=_t(k_eff), pin_ts=_t(pins), with_evictees=True)
    assert_dicts_same(dataclass_arrays(ref_out), dataclass_arrays(port_out),
                      "ring")
    assert_dicts_same(ref_m, port_m, "commit metrics")
    assert int(np_(ref_m["evict_valid"]).sum()) > 0       # spill has work

    ev = [ref_m[k] for k in ("evict_rec", "evict_begin", "evict_end",
                             "evict_payload", "evict_valid")]
    sp = st.versions.spill
    ref_pool = RefPool(sp.begin[0], sp.end[0], sp.rec[0], sp.payload[0])
    port_pool = SpillPool(*(_t(x) for x in (sp.begin[0], sp.end[0],
                                            sp.rec[0], sp.payload[0])))
    ref_p, ref_sm = ref_spill_commit(ref_pool, *ev, wm, pin_ts=pins)
    port_p, port_sm = spill_commit(port_pool, *(_t(x) for x in ev), wm,
                                   pin_ts=_t(pins))
    assert_dicts_same(dataclass_arrays(ref_p), dataclass_arrays(port_p),
                      "spill pool")
    assert_dicts_same(ref_sm, port_sm, "spill metrics")
    assert int(np_(ref_sm["spill_admitted"])) > 0
    if pool == (2, 2):
        assert int(np_(ref_sm["spill_overwrote"])) > 0

    # standalone sweep over the whole (stacked) store, at two watermarks
    for wm_gc in (wm, lo + T):
        ref_v, ref_n = ref_gc_sharded(st.versions, jnp.int32(wm_gc))
        port_store = store_from_reference(ref_store_arrays(st), "cpu")
        port_v, port_n = gc_sharded(port_store.versions, wm_gc)
        assert int(ref_n) == int(port_n)
        assert_dicts_same(dataclass_arrays(ref_v.rings),
                          dataclass_arrays(port_v.rings), "gc rings")
        assert_dicts_same(dataclass_arrays(ref_v.spill),
                          dataclass_arrays(port_v.spill), "gc spill")


def test_store_helpers_match_reference():
    """The small store functions the engine builds on, on one state."""
    eng, _, _ = _engine_state(4, 2, 2)
    st = eng.store
    port = store_from_reference(ref_store_arrays(st), "cpu").versions
    rng = np.random.default_rng(12)
    base = rng.integers(-9, 9, (R, 3)).astype(np.int32)
    base_ts = rng.integers(0, 5, R).astype(np.int32)
    assert_dicts_same(
        dataclass_arrays(ref_ring.init_ring(jnp.asarray(base), base_ts, 3)),
        dataclass_arrays(ring.init_ring(_t(base), _t(base_ts), 3)), "init")
    occ = ref_sh.store_occupancy(st.versions)
    assert_dicts_same({"occ": occ, "fill": ref_ring.ring_fill_fraction(
        occ, ref_sh.to_global(st.versions, st.versions.k_eff))},
        {"occ": sharded.store_occupancy(port),
         "fill": ring.ring_fill_fraction(
             sharded.store_occupancy(port),
             sharded.to_global(port, port.k_eff))}, "occupancy",
        rtol_keys=("fill",))
    recs = np.array([0, 5, -1, R - 1, 17], np.int32)
    for a, b in zip(ref_sh.gather_windows_sharded(st.versions, recs),
                    sharded.gather_windows_sharded(port, _t(recs))):
        np.testing.assert_array_equal(np_(a), np_(b))
    per_rec = rng.integers(0, 50, R).astype(np.int32)
    np.testing.assert_array_equal(
        np_(ref_sh.from_global(st.versions, per_rec)),
        np_(sharded.from_global(port, _t(per_rec))))
    pool = spill.SpillPool(*(x[0] for x in (
        port.spill.begin, port.spill.end, port.spill.rec,
        port.spill.payload)))
    ref_pool = ref_spill.SpillPool(*(x[0] for x in (
        st.versions.spill.begin, st.versions.spill.end,
        st.versions.spill.rec, st.versions.spill.payload)))
    assert int(spill.spill_occupancy(pool)) == int(
        ref_spill.spill_occupancy(ref_pool)) > 0
    np.testing.assert_allclose(float(spill.spill_fill_fraction(pool)),
                               float(ref_spill.spill_fill_fraction(
                                   ref_pool)), rtol=1e-6)
    np.testing.assert_array_equal(
        np_(ref_spill.spill_buckets_for(jnp.asarray(recs), 7)),
        np_(spill.spill_buckets_for(_t(recs), 7)))
    pins = eng.pin_array()
    np.testing.assert_array_equal(
        np_(ref_ring.pin_stabbed(st.versions.rings.begin,
                                 st.versions.rings.end, pins)),
        np_(ring.pin_stabbed(port.rings.begin, port.rings.end, _t(pins))))


def test_carry_roundtrip_is_lossless():
    eng, _, _ = _engine_state(3)
    arrays = ref_store_arrays(eng.store)
    back = store_to_numpy(store_from_reference(arrays, "cpu"))
    assert_dicts_same(arrays, back, "carry")


@pytest.mark.parametrize("theta", [0.0, 0.9])
@pytest.mark.parametrize("mix", ["10rmw", "2rmw8r"])
def test_ycsb_and_scan_generators_equal_under_one_seed(theta, mix):
    a = ref_wl.gen_ycsb_batch(np.random.default_rng(4), 50, 500,
                              theta=theta, mix=mix)
    b = port_wl.gen_ycsb_batch(np.random.default_rng(4), 50, 500,
                               theta=theta, mix=mix, device="cpu")
    assert_dicts_same(dataclass_arrays(a), dataclass_arrays(b), "ycsb")
    a = ref_wl.gen_scan_batch(np.random.default_rng(5), 40, 300, ops=7,
                              theta=theta)
    b = port_wl.gen_scan_batch(np.random.default_rng(5), 40, 300, ops=7,
                               theta=theta, device="cpu")
    assert_dicts_same(dataclass_arrays(a), dataclass_arrays(b), "scan")


@pytest.mark.parametrize("mix", [(0.2,) * 5, (1.0, 0, 0, 0, 0)])
def test_smallbank_generator_and_zipf_equal(mix):
    a = ref_wl.gen_smallbank_batch(np.random.default_rng(6), 80, 30, mix)
    b = port_wl.gen_smallbank_batch(np.random.default_rng(6), 80, 30, mix,
                                    device="cpu")
    assert_dicts_same(dataclass_arrays(a), dataclass_arrays(b), "smallbank")
    for theta in (0.0, 0.5, 0.99):
        np.testing.assert_array_equal(ref_wl.zipf_probs(77, theta),
                                      port_wl.zipf_probs(77, theta))
    rng_a, rng_b = np.random.default_rng(8), np.random.default_rng(8)
    np.testing.assert_array_equal(
        ref_wl._sample_distinct(rng_a, 20, 10, 12, 0.9),
        port_wl._sample_distinct(rng_b, 20, 10, 12, 0.9))
