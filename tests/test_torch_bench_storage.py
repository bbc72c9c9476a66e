"""The port's storage trade-off suites against the reference's
(``benchmarks/{spill,paged}.py`` against ``benchmarks_torch/``), on the
CPU at shrunk sizes: the same module constants are patched on both
modules (the reference's ``paged`` holds its own copies of ``spill``'s,
and its ``CONFIGS`` sizes the slab from ``N_RECORDS``), ``--quick``'s
one timed pass. Rows must be equal in every field but the wall times and
their ratios (``_torch_parity.WALL_KEYS``), floats to rtol 1e-6.
"""
import pytest

from _torch_parity import assert_rows_same
from benchmarks import common as ref_common
from benchmarks import paged as ref_paged
from benchmarks import spill as ref_spill
from benchmarks_torch import common
from benchmarks_torch import paged as port_paged
from benchmarks_torch import spill as port_spill

SMALL = dict(N_RECORDS=2048, HOT_N=128, COLD_N=1024, BATCH=64, N_BATCHES=8)


@pytest.fixture(autouse=True)
def shrunk(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", tmp_path / "ref")
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "port")
    for mod in (ref_spill, ref_paged, port_spill, port_paged):
        for k, v in SMALL.items():
            if hasattr(mod, k):
                monkeypatch.setattr(mod, k, v)
    for mod in (ref_paged, port_paged):
        monkeypatch.setattr(mod, "CONFIGS", tuple(
            (name, dict(kw, pages_per_shard=SMALL["N_RECORDS"]
                        * mod.RING_SLOTS // mod.PAGE_SLOTS)
             if "pages_per_shard" in kw else kw)
            for name, kw in mod.CONFIGS))
    return tmp_path


def test_spill_rows_match_reference():
    """fixed_drop / fixed_spill / adaptive_spill on the hot-set stream
    (``default_rng(61)``): found rates, spill counters, live and dead
    evictions and the effective K spread equal."""
    ref_rows = ref_spill.run(quick=True)
    port_rows = port_spill.run(quick=True, device="cpu")
    assert_rows_same(ref_rows, port_rows, "spill")
    found = [r["found_rate"] for r in port_rows]
    assert found[0] < 1.0 and found[0] < found[1]


def test_paged_rows_match_reference(shrunk):
    """dense_kmax / dense_budget / paged (``default_rng(67)``): physical
    footprint, slab occupancy, pages mapped / free, allocation failures
    and found rates equal."""
    ref_rows = ref_paged.run(quick=True)
    port_rows = port_paged.run(quick=True, device="cpu")
    assert_rows_same(ref_rows, port_rows, "paged")
    paged = port_rows[-1]
    assert paged["config"] == "paged" and paged["pages_mapped"] > 0
    assert (shrunk / "port" / "paged.json").exists()
