"""The port's service and serving suites and its harness tools against
the reference's (``benchmarks/{pipeline,serving,summarize,bench_history,
run}.py`` against ``benchmarks_torch/``), on the CPU at shrunk sizes.

``pipeline``: the reference sees one JAX device here, so it takes the
logical substrate, as the port always does. ``planned_ahead_max`` is
compared too: the service fills its plan window by count
(``max_inflight``) in ``submit_many`` / ``drain`` and never asks the
device whether work is done on that path, so it does not depend on
timing. ``serving`` runs in float32 (config and KV cache, patched on both
modules) with the reference's parameters carried across
(``params_from_reference``), as ``test_torch_serving.py`` does; bf16
token equality is not well posed (ROADMAP "Known limits").
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rows_same
from benchmarks import bench_history as ref_history
from benchmarks import common as ref_common
from benchmarks import pipeline as ref_pipeline
from benchmarks import serving as ref_serving
from benchmarks import summarize as ref_summarize
from benchmarks_torch import bench_history, common, pipeline, run, serving
from benchmarks_torch import summarize
from repro.models import init_params as ref_init_params
from repro_torch.models.transformer import params_from_reference


@pytest.fixture(autouse=True)
def results_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_common, "RESULTS_DIR", tmp_path / "ref")
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "port")
    return tmp_path


def test_pipeline_rows_match_reference(monkeypatch):
    """1, 2 and 4 logical shards, barriered / pipelined / speedup rows
    (``default_rng(31)``, ``--quick``): every field but the wall times
    and their ratio equal."""
    for mod in (ref_pipeline, pipeline):
        monkeypatch.setattr(mod, "N_RECORDS", 1024)
        monkeypatch.setattr(mod, "BATCH", 64)
    ref_rows = ref_pipeline.run(quick=True)
    port_rows = pipeline.run(quick=True, device="cpu")
    assert {r["substrate"] for r in ref_rows} == {"logical"}
    assert_rows_same(ref_rows, port_rows, "pipeline")


def test_serving_rows_match_reference(monkeypatch):
    """Unique prompts and one shared prefix, 12 requests: tokens, prefix
    hits and recycled pages equal (float32, parameters carried)."""
    cfg = dataclasses.replace(serving._cfg(), dtype="float32")
    ref_cfg = dataclasses.replace(ref_serving._cfg(), dtype="float32")
    monkeypatch.setattr(serving, "_cfg", lambda: cfg)
    monkeypatch.setattr(ref_serving, "_cfg", lambda: ref_cfg)
    monkeypatch.setattr(ref_serving, "ServeEngine", functools.partial(
        ref_serving.ServeEngine, kv_dtype=jnp.float32))
    monkeypatch.setattr(serving, "ServeEngine", functools.partial(
        serving.ServeEngine, kv_dtype=torch.float32))
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   cfg, "cpu")
    monkeypatch.setattr(serving, "init_params", lambda *a: params)
    ref_rows = ref_serving.run()
    port_rows = serving.run(device="cpu")
    assert_rows_same(ref_rows, port_rows, "serving")
    assert port_rows[1]["prefix_hits"] > 0


ROWS = {
    "pipeline": [
        {"n_shards": 1, "mode": "pipelined", "substrate": "logical",
         "txn_s": 1000, "pipelined_over_barriered": ""},
        {"n_shards": 1, "mode": "speedup", "substrate": "logical",
         "txn_s": "", "pipelined_over_barriered": 1.25}],
    "spill": [{"config": "fixed_drop", "found_rate": 0.9, "txn_s": 500,
               "spill_dropped": 0}],
    "paged": [{"config": "paged", "phys_kwords": 49, "found_rate": 0.95,
               "txn_s": 400, "pages_mapped": 10, "alloc_failed": 0}],
    "admission_flight": [
        {"ticket": 0, "class": "bulk", "total_ms": 2.0},
        {"ticket": 1, "class": "interactive", "total_ms": 1.0}],
}


def _write_twins(rows_by_name):
    for name, rows in rows_by_name.items():
        ref_common.write_json(name, rows)
        common.write_json(name, rows)


def test_summarize_tables_match_reference(monkeypatch, results_dir,
                                          capsys):
    """The same twins render the same markdown tables (the flight
    fallback included); the observability section reads the port's
    ``obs_health.json``."""
    monkeypatch.setattr(ref_summarize, "RESULTS", results_dir / "ref")
    monkeypatch.setattr(summarize, "RESULTS", results_dir / "port")
    assert not summarize.print_bench_tables()
    capsys.readouterr()
    _write_twins(ROWS)
    assert ref_summarize.print_bench_tables()
    want = capsys.readouterr().out
    assert summarize.print_bench_tables()
    got = capsys.readouterr().out
    assert got == want and "flight" in got and "| 1.25 |" in got
    assert summarize.BENCH_TABLES == ref_summarize.BENCH_TABLES
    assert not summarize.print_obs_section()
    (results_dir / "port" / "obs_health.json").write_text(json.dumps(
        {"meta": {"torch_version": torch.__version__}, "health":
         {"watermark_lag": 3}, "phases": [
             {"phase": "exec_phase", "count": 2, "mean_ms": 1.5,
              "p50_ms": 1.5, "max_ms": 2.0, "anomalies": 0}]}))
    assert summarize.print_obs_section()
    out = capsys.readouterr().out
    assert "| exec_phase | 2 | 1.5 |" in out and "| watermark_lag | 3 |" in out


def test_bench_history_matches_reference(monkeypatch, results_dir):
    """Headline metrics appended from the same twins are equal, histories
    land under the root named (never the repo root), and the gate flags
    the same regression on a third entry."""
    monkeypatch.setattr(ref_summarize, "RESULTS", results_dir / "ref")
    monkeypatch.setattr(summarize, "RESULTS", results_dir / "port")
    ref_root, root = results_dir / "ref_hist", results_dir / "port_hist"
    assert bench_history.HISTORY_DIR.parent.name == "benchmarks_torch"
    assert set(bench_history.SUITES) == set(ref_history.SUITES)
    for txn_s in (1000, 1010, 300):
        rows = dict(ROWS, pipeline=[dict(ROWS["pipeline"][0],
                                         txn_s=txn_s)])
        _write_twins(rows)
        ref_root.mkdir(exist_ok=True)
        assert ref_history.append_suites(["pipeline", "spill"],
                                         root=ref_root) == \
            bench_history.append_suites(["pipeline", "spill"], root=root)
    for suite in ("pipeline", "spill"):
        want = json.loads((ref_root / f"BENCH_{suite}.json").read_text())
        got = json.loads((root / f"BENCH_{suite}.json").read_text())
        assert [e["metrics"] for e in got["entries"]] == \
            [e["metrics"] for e in want["entries"]]
    want = ref_history.check_suites(["pipeline", "spill"], root=ref_root)
    got = bench_history.check_suites(["pipeline", "spill"], root=root)
    assert [r.describe() for r in got] == [r.describe() for r in want]
    assert [r.metric for r in got] == ["shards1_txn_s"]


def test_run_suite_map_and_cli(monkeypatch):
    """The reference's suites in its order, each a module with ``run``;
    the CLI rejects an unknown name and exits 2 without a GPU."""
    import importlib
    import sys
    assert list(run.SUITES) == [
        "microbench", "ycsb", "smallbank", "snapshot", "pipeline",
        "admission", "spill", "paged", "kernels", "serving", "arena"]
    for name in run.SUITES:
        assert callable(importlib.import_module(
            f"benchmarks_torch.{name}").run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["run.py", "--quick"])
    assert run.main() == 2
    monkeypatch.setattr(sys, "argv", ["run.py", "--only", "snapshots"])
    with pytest.raises(SystemExit):
        run.main()
