"""The port's Fig 9/10 and Fig 4 suites and its kernel rows against the
reference's (``benchmarks/{snapshot,microbench,kernels}.py`` against
``benchmarks_torch/``), on the CPU at shrunk sizes: the same module
constants are patched on both modules, the reference runs on JAX's CPU
(Pallas in interpret mode), the port with ``device="cpu"``. Rows must be
equal in every field but the wall times (``_torch_parity.WALL_KEYS``),
floats to rtol 1e-6. Also ``bohm_step`` against the reference's
``BohmEngine._step``, and the pinned-scan probe that ``chip_smoke.py``
phase 13 checks on the card.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_rows_same, port_batch, ref_store_arrays
from benchmarks import common as ref_common
from benchmarks import kernels as ref_kernels
from benchmarks import microbench as ref_micro
from benchmarks import snapshot as ref_snapshot
from benchmarks_torch import common
from benchmarks_torch.common import is_wall_key
from benchmarks_torch import kernels as port_kernels
from benchmarks_torch import microbench as port_micro
from benchmarks_torch import snapshot as port_snapshot
from repro.core.engine import BohmEngine as RefEngine
from repro.core.workloads import gen_ycsb_batch as ref_gen_ycsb
from repro.core.workloads import make_microbench as ref_make_microbench
from repro_torch.core.carry import store_to_numpy
from repro_torch.core.engine import BohmEngine
from repro_torch.core.workloads import make_microbench


@pytest.fixture(autouse=True)
def results_dir(monkeypatch, tmp_path):
    """Both packages' JSON twins go to a temporary directory."""
    monkeypatch.setattr(ref_common, "RESULTS_DIR", tmp_path / "ref")
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "port")
    return tmp_path


def _shrink(monkeypatch, modules, **values):
    for mod in modules:
        for k, v in values.items():
            monkeypatch.setattr(mod, k, v)


def test_snapshot_rows_match_reference(monkeypatch, results_dir):
    """All four cells (SmallBank / YCSB, unpinned / pinned) in ``run()``'s
    order from one ``default_rng(29)``: found fraction, occupancy,
    evictions and live overwrites equal; the JSON twin holds the rows."""
    _shrink(monkeypatch, (ref_snapshot, port_snapshot), N_RECORDS=2048,
            BATCH=128, N_BATCHES=4)
    monkeypatch.setattr(port_snapshot, "SMALLBANK_CUSTOMERS", 1024)
    ref_rows = ref_snapshot.run()
    port_rows = port_snapshot.run(num_records=2048, device="cpu")
    assert_rows_same(ref_rows, port_rows, "snapshot")
    assert [r["overwrote_live"] for r in port_rows] != [0] * 4
    assert (results_dir / "port" / "snapshot.json").exists()


def test_snapshot_probe_returns_the_pinned_state(monkeypatch):
    """The pinned YCSB cell with a probe (what phase 13 (b) checks on the
    card at 1,000,000 records): every scan read that is found equals the
    state at the pin, and the probe leaves the row as it was."""
    _shrink(monkeypatch, (port_snapshot,), N_RECORDS=1024, BATCH=128,
            N_BATCHES=5)
    probe = {}
    row = port_snapshot.bench_cell("ycsb", True, np.random.default_rng(5),
                                   1024, "cpu", probe=probe)
    plain = port_snapshot.bench_cell("ycsb", True,
                                     np.random.default_rng(5), 1024, "cpu")
    assert {k: v for k, v in row.items() if not is_wall_key(k)} == \
        {k: v for k, v in plain.items() if not is_wall_key(k)}
    assert len(probe["scans"]) == port_snapshot.N_BATCHES - 1
    for scan, vals, found in probe["scans"]:
        want = probe["at_pin"][scan.read_set.long()]
        assert bool(found.any())
        assert torch.equal(vals[found], want[found])


def test_microbench_rows_match_reference(monkeypatch):
    """The ``cc_shards=1`` column: batch sizes, waves and row keys equal
    (on one device neither runs the mesh columns;
    ``test_torch_mesh_plan.py`` rehearses them)."""
    _shrink(monkeypatch, (ref_micro, port_micro), N_RECORDS=8192)
    sizes = (64, 256)
    ref_rows = ref_micro.run(cc_shards=(1,), batch_sizes=sizes)
    port_rows = port_micro.run(batch_sizes=sizes, device="cpu")
    assert_rows_same(ref_rows, port_rows, "microbench")


@pytest.mark.parametrize("kw", [{}, dict(n_shards=2)])
def test_bohm_step_matches_reference_step(kw):
    """``BohmEngine._step`` (``bohm_step``) on the engine's store: reads,
    metrics and the returned store equal the reference's ``_step``, and
    the engine's own store is left as it was."""
    R = 2048
    rng = np.random.default_rng(11)
    batches = [ref_gen_ycsb(rng, 128, R, theta=0.0, mix="10rmw")
               for _ in range(2)]
    ref = RefEngine(R, ref_make_microbench(), **kw)
    port = BohmEngine(R, make_microbench(), device="cpu", **kw)
    ref.run_batch(batches[0])
    port.run_batch(port_batch(batches[0]))
    before = store_to_numpy(port.store)
    r_store, r_reads, r_metrics = ref._step(ref.store, batches[1])
    p_store, p_reads, p_metrics = port._step(port.store,
                                             port_batch(batches[1]))
    np.testing.assert_array_equal(p_reads.numpy(), np.asarray(r_reads))
    for k in ("waves", "aborts", "ring_evicted", "ring_overwrote_live"):
        assert int(p_metrics[k]) == int(r_metrics[k]), k
    want = ref_store_arrays(r_store)
    got = store_to_numpy(p_store)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    for k, a in store_to_numpy(port.store).items():
        np.testing.assert_array_equal(a, before[k], err_msg=k)


def test_kernels_rows_match_reference(monkeypatch):
    """The two kernel rows at the reference's shapes: kernel, shape,
    backend and ``allclose`` equal; ``ref_us`` / ``pallas_us`` are
    ``plain_us`` / ``kernel_us`` and ``interpret`` is gone. Timing is
    cut to one call each on both sides (only wall times change)."""
    def once(fn, *args, **kw):
        fn(*args, **kw)
        return 1e-6

    monkeypatch.setattr(ref_kernels, "time_fn", once)
    monkeypatch.setattr(port_kernels, "time_fn", once)
    ref_rows = ref_kernels.run()
    port_rows = port_kernels.run(device="cpu")
    assert_rows_same(ref_rows, port_rows, "kernels",
                     renamed={"ref_us": "plain_us",
                              "pallas_us": "kernel_us"},
                     dropped=("interpret",))
    assert all(r["allclose"] for r in port_rows)
