"""Logical shards (``n_shards > 1`` on one device): the port against the
JAX reference's no-mesh substrate on the same seeded streams.

Global record ``r`` lives at ``[r % n, r // n]`` with ``Rl = ceil(R /
n)`` (R = 250 is not a multiple of 4, so the last shards hold
hash-padding records). Four stream configurations — the dense ring
without spill, the default dense ring with spill, the paged slab with
fixed K and with adaptive K — run at n = 2 and n = 4. Compared byte for
byte: per-batch reads and integer metrics, every store array (stacked
[n, Rl, ...] layout included), pinned ``snapshot_read`` /
``run_readonly_batch`` values and ``found`` before and after each sweep,
``k_by_record``, ``overflow_stats``, ``spill_stats``, ``storage_stats``
and the registry's integer counters; the float32 gauges to rtol=1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_dicts_same, assert_same, dataclass_arrays,
                           fresh_ref_engine, np_, port_batch,
                           ref_store_arrays)
from repro.core import workloads as ref_wl
from repro.store import sharded as ref_sh
from repro_torch.core import workloads as port_wl
from repro_torch.core.carry import store_from_reference, store_to_numpy
from repro_torch.core.engine import BohmEngine
from repro_torch.store import sharded

R, T = 250, 48
CONFIGS = {
    "dense": dict(ring_slots=2, spill_slots=0),
    "spill": dict(ring_slots=2, spill_buckets=8, spill_slots=8),
    "paged_fixed": dict(ring_slots=4, spill_buckets=8, spill_slots=8,
                        paged=True, page_slots=2, pages_per_shard=160),
    "paged_adaptive": dict(ring_slots=4, spill_buckets=8, spill_slots=8,
                           adaptive_k=True, k_max=8, paged=True,
                           page_slots=2, pages_per_shard=160),
}


def _engines(kw):
    ref = fresh_ref_engine(R, "ycsb2x4",
                           lambda: ref_wl.make_ycsb(payload_words=2, ops=4),
                           **kw)
    port = BohmEngine(R, port_wl.make_ycsb(payload_words=2, ops=4),
                      device="cpu", **kw)
    return ref, port


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


def _check_reads(ref, port, pins, scan, msg):
    recs = np.arange(R)
    for r_pin, p_pin in pins + [(None, None)]:
        for a, b in zip(ref.snapshot_read(recs, r_pin),
                        port.snapshot_read(recs, p_pin)):
            assert_same(a, b, f"{msg}: snapshot_read")
        r_v, r_f, r_m = ref.run_readonly_batch(scan, r_pin)
        p_v, p_f, p_m = port.run_readonly_batch(port_batch(scan), p_pin)
        assert_same(r_v, p_v, f"{msg}: readonly vals")
        assert_same(r_f, p_f, f"{msg}: readonly found")
        assert_dicts_same(r_m, p_m, f"{msg}: readonly metrics")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_logical_shard_stream_parity(config, n):
    kw = dict(CONFIGS[config], n_shards=n)
    ref, port = _engines(kw)
    assert port.n_shards == ref.n_shards == n
    assert port.store.versions.records_per_shard == -(-R // n)
    rng = np.random.default_rng(20 + n)
    scan = ref_wl.gen_scan_batch(np.random.default_rng(21), 12, R, ops=4)
    pins = []
    for i in range(6):
        batch = ref_wl.gen_ycsb_batch(rng, T, R, theta=1.1, ops=4)
        r_vals, r_m = ref.run_batch(batch)
        p_vals, p_m = port.run_batch(port_batch(batch))
        assert_same(r_vals, p_vals, f"{config}/{n} batch {i}: reads")
        assert_dicts_same(r_m, p_m, f"{config}/{n} batch {i}")
        if i % 2 == 1:
            pins.append((ref.begin_snapshot(), port.begin_snapshot()))
            while len(pins) > 2:
                r_pin, p_pin = pins.pop(0)
                ref.release_snapshot(r_pin)
                port.release_snapshot(p_pin)
            _check_reads(ref, port, pins, scan, f"{config}/{n} {i}")
            assert ref.gc_sweep() == port.gc_sweep()
            _check_state(ref, port, f"{config}/{n} sweep {i}")
    _check_reads(ref, port, pins, scan, f"{config}/{n} end")
    assert int(np_(port.overflow_by_record()).sum()) > 0   # it overflowed
    if kw.get("spill_slots"):
        assert port.spill_stats()["spill_admitted"] > 0
    if kw.get("adaptive_k"):
        assert port.metrics.get("engine/k_slots_granted", 0) > 0


@pytest.mark.parametrize("paged", [False, True])
def test_sharded_helpers_match_reference(paged):
    """``init_sharded_store``, ``global_record_ids``, ``to_global`` /
    ``from_global``, occupancy, ``store_health``,
    ``gather_windows_sharded``, ``resolve_sharded`` and ``gc_sharded`` at
    n = 4 on a committed store, and the state carried across."""
    n = 4
    kw = dict(CONFIGS["paged_fixed" if paged else "spill"], n_shards=n)
    ref, port = _engines(kw)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = ref_wl.gen_ycsb_batch(rng, T, R, theta=1.1, ops=4)
        ref.run_batch(batch)
        port.run_batch(port_batch(batch))
    st = ref.store.versions
    carried = store_from_reference(ref_store_arrays(ref.store), "cpu")
    assert_dicts_same(store_to_numpy(carried), store_to_numpy(port.store),
                      "carried")
    pv = port.store.versions
    assert_same(ref_sh.global_record_ids(n, st.records_per_shard),
                sharded.global_record_ids(n, pv.records_per_shard),
                "global_record_ids")
    assert_same(ref_sh.store_occupancy(st), sharded.store_occupancy(pv),
                "store_occupancy")
    assert_dicts_same(ref_sh.store_health(st), sharded.store_health(pv),
                      "store_health", rtol_keys=("slab_fill", "spill_fill"))
    per_record = np.arange(R, dtype=np.int32) * 3
    assert_same(ref_sh.from_global(st, per_record, pad_value=-7),
                sharded.from_global(pv, torch.from_numpy(per_record),
                                    pad_value=-7), "from_global")
    assert_same(ref_sh.to_global(st, st.k_eff),
                sharded.to_global(pv, pv.k_eff), "to_global")
    recs = np.array([0, 9, R - 1, 17, 3, 4, 5, 6, 200], np.int32)
    for a, b in zip(ref_sh.gather_windows_sharded(st, recs),
                    sharded.gather_windows_sharded(pv, torch.from_numpy(
                        recs))):
        assert_same(a, b, "gather_windows_sharded")
    ts = np.full(len(recs), ref.current_ts() - 40, np.int32)
    for a, b in zip(ref_sh.resolve_sharded(st, recs, ts, interpret=True),
                    sharded.resolve_sharded(pv, torch.from_numpy(recs),
                                            torch.from_numpy(ts))):
        assert_same(a, b, "resolve_sharded")
    wm = ref.current_ts() - 20
    ref_v, ref_n = ref_sh.gc_sharded(st, jnp.int32(wm))
    port_v, port_n = sharded.gc_sharded(pv, wm)
    assert int(ref_n) == int(port_n) > 0
    prim = "pages" if paged else "rings"
    assert_dicts_same(dataclass_arrays(getattr(ref_v, prim)),
                      dataclass_arrays(getattr(port_v, prim)), "gc primary")
    assert_dicts_same(dataclass_arrays(ref_v.spill),
                      dataclass_arrays(port_v.spill), "gc spill")
    if not paged:
        assert_dicts_same(dataclass_arrays(ref_sh.unshard(st)),
                          dataclass_arrays(sharded.unshard(pv)), "unshard")
