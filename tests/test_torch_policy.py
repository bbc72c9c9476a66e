"""The port's adaptive-K policy (``repro_torch.store.policy``) against the
reference (``repro.store.policy``): the same numpy inputs, byte-equal
outputs.

The cases are drawn by the seeded generator of
``tests/test_policy_props.py`` (a few hundred per quantum), with and
without ``occupancy``, ``stable_idle`` and ``k_base``; ``decay_pressure``
is compared to the last bit (both are float64 numpy) and ``reassign_stats``
dict for dict. The errors the reference raises are raised by the port.
The stream of ``benchmarks/spill.py`` (fixed K without and with spill,
adaptive K) runs through both engines with equal found rates.
"""
import numpy as np
import pytest

from _torch_parity import fresh_ref_engine, np_, port_batch
from benchmarks import spill as bench
from repro.core import workloads as ref_wl
from repro.store import policy as ref_policy
from repro_torch.core import workloads as port_wl
from repro_torch.core.engine import BohmEngine
from repro_torch.store import policy


def _case(rng, quantum):
    """One input of ``test_policy_props.py``'s seeded sweep, at a fixed
    quantum."""
    n = int(rng.integers(1, 40))
    k_max = quantum * int(rng.integers(1, 8))
    k = quantum * rng.integers(1, k_max // quantum + 1, n)
    pressure = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 50, n))
    occupancy = rng.integers(0, k_max + 2, n)
    stable_idle = rng.random(n) < 0.5
    k_base = int(rng.integers(1, k_max + 1)) if rng.random() < 0.5 else None
    return pressure, k, occupancy, stable_idle, k_max, k_base


@pytest.mark.parametrize("quantum", [1, 2])
@pytest.mark.parametrize("with_occ,with_idle", [(True, True), (True, False),
                                                (False, False)])
def test_reassign_k_matches_reference(quantum, with_occ, with_idle):
    rng = np.random.default_rng(100 * quantum + 10 * with_occ + with_idle)
    moved = 0
    for case in range(300):
        pressure, k, occ, idle, k_max, k_base = _case(rng, quantum)
        kw = dict(k_min=1, k_max=k_max, k_base=k_base,
                  occupancy=occ if with_occ else None,
                  stable_idle=idle if with_idle else None,
                  budget=int(k.sum()), quantum=quantum)
        ref = ref_policy.reassign_k(pressure, k, **kw)
        out = policy.reassign_k(pressure, k, **kw)
        assert out.dtype == ref.dtype, case
        np.testing.assert_array_equal(out, ref, err_msg=f"case {case}")
        assert policy.reassign_stats(k, out, quantum) == \
            ref_policy.reassign_stats(k, ref, quantum)
        moved += int((out != k).any())
        # the pass is a fixpoint on both sides
        np.testing.assert_array_equal(policy.reassign_k(pressure, out, **kw),
                                      ref_policy.reassign_k(pressure, ref,
                                                            **kw))
    assert moved > 30               # the sweep exercises real transfers


def test_decay_pressure_matches_reference():
    rng = np.random.default_rng(7)
    prev_r = prev_p = np.zeros(50)
    for step in range(40):
        delta = np.where(rng.random(50) < 0.3, rng.integers(0, 9, 50), 0)
        half_life = float(rng.choice([0.5, 1.0, 2.0, 3.5]))
        prev_r = ref_policy.decay_pressure(prev_r, delta, half_life)
        prev_p = policy.decay_pressure(prev_p, delta, half_life)
        assert prev_p.dtype == prev_r.dtype == np.float64
        np.testing.assert_array_equal(prev_p, prev_r, err_msg=str(step))
    with pytest.raises(ValueError):
        policy.decay_pressure(prev_p, np.zeros(50), 0.0)


@pytest.mark.parametrize("bad", [dict(k_min=0), dict(quantum=2, k=3),
                                 dict(quantum=2, k_max=7),
                                 dict(budget=10)])
def test_policy_errors_match_reference(bad):
    args = dict(k_min=1, k_max=8, quantum=1, k=4, budget=None)
    args.update(bad)
    k = np.full(8, args.pop("k"))
    pressure = np.arange(8)
    for fn in (ref_policy.reassign_k, policy.reassign_k):
        with pytest.raises(ValueError):
            fn(pressure, k, **args)


@pytest.mark.parametrize("config", ["fixed_drop", "fixed_spill",
                                    "adaptive_spill"])
def test_bench_spill_stream_matches_reference(config):
    """The three configurations of ``benchmarks/spill.py`` on its stream
    (``_hotset_batch``, ``default_rng(61)``, 16 batches, rolling pins and
    sweeps), one untimed pass through each package: equal found rates,
    capacities, spill counters and live-eviction histograms. The found
    rates are also printed beside ``BENCH_spill.json`` (0.9387, 0.9433,
    0.958; older code on JAX 0.4.37, so a comparison, not a gate)."""
    rng = np.random.default_rng(61)
    batches = [bench._hotset_batch(rng) for _ in range(bench.N_BATCHES)]
    kw = dict(bench.CONFIGS)[config]
    ref = fresh_ref_engine(bench.N_RECORDS, "bench",
                           lambda: ref_wl.make_ycsb(payload_words=2,
                                                    ops=bench.OPS), **kw)
    port = BohmEngine(bench.N_RECORDS,
                      port_wl.make_ycsb(payload_words=2, ops=bench.OPS),
                      device="cpu", **kw)
    r_pins = bench._run_stream(ref, batches)
    p_pins = []
    for i, batch in enumerate(batches):         # _run_stream, on the port
        port.run_batch(port_batch(batch))
        if (i + 1) % bench.PIN_EVERY == 0:
            p_pins.append(port.begin_snapshot())
            while len(p_pins) > bench.PINS_HELD:
                port.release_snapshot(p_pins.pop(0))
            port.gc_sweep()
    probe = np.arange(bench.HOT_N + bench.COLD_N)
    found = [np.concatenate([np_(eng.snapshot_read(probe, p)[1])
                             for p in pins]).mean()
             for eng, pins in ((ref, r_pins), (port, p_pins))]
    assert found[0] == found[1]
    np.testing.assert_array_equal(np_(ref.k_by_record()),
                                  np_(port.k_by_record()))
    np.testing.assert_array_equal(np_(ref.overflow_by_record()),
                                  np_(port.overflow_by_record()))
    assert ref.spill_stats() == port.spill_stats()
    print(f"BENCH_spill {config}: found_rate {found[1]:.4f}")
