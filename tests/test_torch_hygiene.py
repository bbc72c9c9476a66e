"""Package rules of the port: it imports neither ``jax`` nor ``repro``
(nor do ``chip_smoke.py``, ``benchmarks_torch/`` and ``examples_torch/``,
which also import nothing of the reference's ``benchmarks``), and its entry
points never fall back to the CPU — without a GPU they raise unless the
caller asks for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|benchmarks)\b(?!_torch)", re.MULTILINE)


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_package_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.core.engine" in mods
    assert {f"repro_torch.obs.{m}" for m in (
        "ewma", "trace", "lifecycle", "monitor", "regress")} <= set(mods)
    assert {f"repro_torch.models.{m}" for m in (
        "layers", "attention", "ffn", "ssm", "transformer")} <= set(mods)
    assert {"repro_torch.training.optimizer",
            "repro_torch.training.compression",
            "repro_torch.training.train_loop", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.manager", "repro_torch.ft.monitor",
            "repro_torch.launch.mesh", "repro_torch.launch.train",
            "repro_torch.launch.serve"} <= set(mods)
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_package_and_mesh_path_import_no_torch_testing():
    """Importing every module of the package, and building and driving a
    one-rank ``cc`` mesh engine over gloo, loads nothing of
    ``torch.testing._internal.distributed``: only the tests and
    ``chip_smoke.py`` use torch's threaded process group. (DTensor
    itself imports two other ``torch.testing._internal`` modules.)"""
    code = (
        "import sys, importlib, pkgutil, torch\n"
        "import torch.distributed as dist\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.core.engine import BohmEngine\n"
        "from repro_torch.core.txn import make_batch\n"
        "from repro_torch.core.workloads import make_ycsb\n"
        "from repro_torch.launch.mesh import cc_mesh\n"
        "dist.init_process_group('gloo', store=dist.HashStore(), rank=0, "
        "world_size=1)\n"
        "eng = BohmEngine(16, make_ycsb(2, 2), mesh=cc_mesh('cpu'), "
        "device='cpu')\n"
        "eng.run_batch(make_batch([[1, 2]], [[1, 2]], [0], [[1]], "
        "device='cpu'))\n"
        "eng.snapshot_read(torch.arange(16)); eng.gc_sweep()\n"
        "bad = [m for m in sys.modules if m.startswith("
        "'torch.testing._internal.distributed')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PKG.rglob("*.py"), *(ROOT / "benchmarks_torch").rglob("*.py"),
        *(ROOT / "examples_torch").glob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_jax_or_repro_import_statement(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


ML_DTYPES = re.compile(r"^\s*(import|from)\s+ml_dtypes\b", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PKG.rglob("*.py"), *(ROOT / "benchmarks_torch").rglob("*.py"),
        *(ROOT / "examples_torch").glob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_ml_dtypes_import_statement(path):
    """The card's machine has no ``ml_dtypes``: bf16 crosses numpy as its
    uint16 bits (``checkpoint/manager.py``)."""
    assert not ML_DTYPES.search((ROOT / path).read_text()), path


def test_hardware_model_is_the_h100s():
    """``launch/mesh.py`` carries the H100's figures, which
    ``chip_smoke.py`` imports, and none of the reference's TPU v5e ones
    (197e12 FLOP/s, 819e9 and 50e9 bytes/s)."""
    from repro_torch.launch import mesh
    text = (PKG / "launch" / "mesh.py").read_text()
    figures = {float(x) for x in re.findall(r"\d+(?:\.\d+)?e\d+", text)}
    assert figures and not figures & {197e12, 819e9, 50e9}
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_FP32, mesh.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.launch.mesh import HBM_BW" in smoke
    assert not re.search(r"^(HBM_BYTES_PER_S|FP32_OPS_PER_S|BF16_OPS_PER_S)"
                         r"\s*=", smoke, re.MULTILINE)


def test_entry_points_raise_without_gpu(monkeypatch):
    from repro_torch.configs.bohm_workloads import YCSB_LOW_10RMW, build
    from repro_torch.core.engine import BohmEngine
    from repro_torch.core.txn import make_batch
    from repro_torch.core.workloads import make_ycsb
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BohmEngine(16, make_ycsb())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(YCSB_LOW_10RMW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch([[0]], [[0]], [0], [[0]])
    assert BohmEngine(16, make_ycsb(), device="cpu").device.type == "cpu"


def test_serve_engine_raises_without_gpu(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import ServeEngine
    cfg = reduced_config("smollm-360m")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, device="cuda")
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_non_cpu_tensor_never_reaches_plain_version(monkeypatch):
    """A tensor that is not on the CPU takes the kernel path or raises;
    it never reaches the plain version."""
    from repro_torch.kernels import mvcc_resolve as mod

    def boom(*args, **kwargs):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(mod, "mvcc_resolve_plain", boom)
    monkeypatch.setattr(mod, "mvcc_resolve_masked_plain", boom)
    monkeypatch.setattr(mod, "mvcc_resolve_paged_plain", boom)
    z = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    d = torch.zeros((4, 2, 3), dtype=torch.int32, device="meta")
    t = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        mod.mvcc_resolve(z, z, d, t)
    with pytest.raises(ValueError, match="no kernel"):
        mod.mvcc_resolve_masked(z, z, z, t, d, t)
    rows = torch.zeros((5,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        mod.mvcc_resolve(z, z, d, rows, rows=rows)
    prior = (torch.zeros((5, 3), dtype=torch.int32, device="meta"),
             torch.zeros((5,), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        mod.mvcc_resolve_masked(z, z, z, rows, d, rows, in_place=True,
                                prior=prior)
    with pytest.raises(ValueError, match="no kernel"):
        mod.mvcc_resolve_paged(z, z, z, d, t)


def test_attention_non_cpu_tensor_never_reaches_plain(monkeypatch):
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod

    def boom(*args, **kw):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(dmod, "decode_attention_plain", boom)
    monkeypatch.setattr(fmod, "flash_attention_causal_plain", boom)
    q = torch.zeros((2, 1, 3, 8), device="meta")
    k = torch.zeros((2, 5, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dmod.decode_attention(q, k, k, torch.zeros(
            (2,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fmod.flash_attention_causal(torch.zeros((1, 5, 1, 3, 8),
                                                device="meta"),
                                    k[:1], k[:1])


@pytest.mark.parametrize("kwargs", [dict(n_shards=2),
                                    dict(paged=True, n_shards=4)])
def test_logical_shard_options_run(kwargs):
    """``n_shards > 1`` (logical shards on one device), dense and paged,
    builds and runs a batch on the CPU."""
    from repro_torch.core.engine import BohmEngine
    from repro_torch.core.txn import make_batch
    from repro_torch.core.workloads import make_ycsb
    eng = BohmEngine(16, make_ycsb(payload_words=2, ops=2), device="cpu",
                     **kwargs)
    assert eng.n_shards == kwargs["n_shards"]
    batch = make_batch([[1, 2], [2, 3]], [[1, 2], [2, 3]], [0, 0],
                       [[5], [7]], device="cpu")
    vals, _ = eng.run_batch(batch)
    assert tuple(vals.shape) == (2, 2, 2)
    got, found = eng.snapshot_read(torch.arange(16, dtype=torch.int32))
    assert bool(found.all())
    assert torch.equal(got, eng.snapshot())


@pytest.mark.parametrize("kwargs", [dict(adaptive_k=True, mesh=object()),
                                    dict(mesh=object()),
                                    dict(n_shards=2, mesh=object()),
                                    dict(auditor="audited", mesh=object())])
def test_unported_options_raise(kwargs):
    """Every option of the reference engine is ported; ``mesh=`` takes a
    ``DeviceMesh`` (``tests/test_torch_mesh_engine.py`` drives it), and
    anything else raises, also beside the paged, adaptive-K,
    logical-shard and lifecycle-auditor options."""
    from repro_torch.core.engine import BohmEngine
    from repro_torch.core.workloads import make_ycsb
    from repro_torch.obs import LifecycleAuditor
    if kwargs.get("auditor") == "audited":
        kwargs = dict(kwargs, auditor=LifecycleAuditor())
    with pytest.raises(TypeError, match="DeviceMesh"):
        BohmEngine(16, make_ycsb(), device="cpu", **kwargs)


@pytest.mark.parametrize("target", [
    "benchmarks_torch.snapshot", "benchmarks_torch.spill",
    "benchmarks_torch.paged", "benchmarks_torch.pipeline",
    "benchmarks_torch.microbench", "benchmarks_torch.kernels",
    "benchmarks_torch.serving", "examples_torch.quickstart",
    "examples_torch.serve_batched"])
def test_suites_and_examples_raise_without_gpu(monkeypatch, target):
    """The paper's suites and the examples run on the card by default:
    without a GPU ``run()`` / ``main()`` raise instead of measuring the
    CPU."""
    import importlib
    mod = importlib.import_module(target)
    entry = getattr(mod, "run", None) or mod.main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
