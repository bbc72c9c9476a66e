"""The port's training path against the JAX package's, on the CPU:
``training/{optimizer,compression,train_loop}``, ``data/pipeline``,
``checkpoint/manager``, ``ft/monitor`` and the launchers.

Each test gives both packages the same numpy inputs (parameters through
``params_from_reference`` / ``opt_state_from_reference``, batches from
the same seeded pipeline). Integer and bit-level results are compared
exactly: compression, data batches, checkpoints (both directions), the
straggler and remesh decisions. Float results of the same float32
arithmetic are held to 1e-4 of their largest magnitude (AdamW to 1e-6:
one step of elementwise arithmetic).
"""
import dataclasses
import importlib.util
import json
import time
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import np_
from repro.checkpoint.manager import CheckpointManager as RefCkpt
from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import PackedBatchIterator as RefPacked
from repro.data.pipeline import SyntheticTokenSource as RefSource
from repro.ft import monitor as ref_monitor
from repro.models import init_params as ref_init_params
from repro.training import optimizer as ref_opt
from repro.training.compression import CompressionConfig as RefCompression
from repro.training.compression import compress_grads as ref_compress
from repro.training.train_loop import TrainConfig as RefTrainConfig
from repro.training.train_loop import Trainer as RefTrainer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import PackedBatchIterator, SyntheticTokenSource
from repro_torch.ft import monitor
from repro_torch.models import layers, transformer
from repro_torch.training import optimizer as opt
from repro_torch.training.compression import CompressionConfig, compress_grads
from repro_torch.training.train_loop import (TrainConfig, Trainer,
                                             make_train_step)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m"
TOL = 1e-4


def _cfgs(dtype="float32"):
    return (dataclasses.replace(reduced_config(ARCH), dtype=dtype),
            dataclasses.replace(ref_reduced_config(ARCH), dtype=dtype))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's float32 parameters of the reduced smollm (numpy)."""
    _, ref_cfg = _cfgs()
    return jax.tree.map(np.asarray, jax.jit(
        ref_init_params, static_argnums=0)(ref_cfg, jax.random.PRNGKey(0)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _random_tree(seed: int, dtype):
    """A small parameter-like tree: matrices (decayed) and vectors (not)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 12)).astype(np.float32),
            "blk": {"b": rng.standard_normal((12,)).astype(np.float32),
                    "k": rng.standard_normal((3, 4, 5)).astype(np.float32)}}


def _to_port(tree, dtype=torch.float32):
    return {k: _to_port(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def _to_ref(tree, dtype=jnp.float32):
    return {k: _to_ref(v, dtype) if isinstance(v, dict)
            else jnp.asarray(v, dtype) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# optimizer, compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, steps):
    """``adamw_update`` from the same parameters, gradients and state:
    parameters (in their dtype), moments, step and grad norm; the second
    gradient is scaled past the clip norm."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    params = _random_tree(0, dtype)
    p_port, p_ref = _to_port(params, tdt), _to_ref(params, jdt)
    s_port, s_ref = opt.init_opt_state(p_port), ref_opt.init_opt_state(p_ref)
    cfg = opt.AdamWConfig(lr=1e-2)
    ref_cfg = ref_opt.AdamWConfig(lr=1e-2)
    for i in range(steps):
        g = jax.tree.map(lambda x: x * (0.3 + 4 * i), _random_tree(10 + i,
                                                                  dtype))
        p_port, s_port, m_port = opt.adamw_update(p_port, _to_port(g, tdt),
                                                  s_port, cfg)
        p_ref, s_ref, m_ref = ref_opt.adamw_update(p_ref, _to_ref(g, jdt),
                                                   s_ref, ref_cfg)
        assert _rel(np_(m_port["grad_norm"]), m_ref["grad_norm"]) <= 1e-6
    tol = 1e-6 if dtype == "float32" else 2 ** -7      # one bf16 ulp
    for name, r in _flat(p_ref).items():
        p = _flat(p_port)[name]
        assert p.dtype == tdt
        assert _rel(p.float().numpy(), np.asarray(r, np.float32)) <= tol
    for part in ("m", "v"):
        for name, r in _flat(s_ref[part]).items():
            assert _rel(np_(_flat(s_port[part])[name]), r) <= 1e-5, name
    assert int(s_port["step"]) == int(s_ref["step"]) == steps
    assert s_port["step"].dtype == torch.int32


@pytest.mark.parametrize("chunk", [1 << 26, 100, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_update_is_the_same_bits(monkeypatch, dtype, chunk):
    """``adamw_update(donate=True)``: the same parameters, moments, step
    and grad norm bit for bit as the undonated update, a leaf larger than
    ``DONATE_CHUNK`` taken in slices (100 and 7 elements cut every leaf
    here), each written over its input tensor."""
    tdt = getattr(torch, dtype)
    base = _random_tree(0, dtype)
    g = _random_tree(10, dtype)
    want = opt.adamw_update(_to_port(base, tdt), _to_port(g, tdt),
                            opt.init_opt_state(_to_port(base, tdt)))
    monkeypatch.setattr(opt, "DONATE_CHUNK", chunk)
    params, grads = _to_port(base, tdt), _to_port(g, tdt)
    state = opt.init_opt_state(params)
    got = opt.adamw_update(params, grads, state, donate=True)
    for a, b in zip(got[:2], want[:2]):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for name in fa:
            assert fa[name].dtype == fb[name].dtype
            assert torch.equal(fa[name], fb[name]), name
    assert torch.equal(got[2]["grad_norm"], want[2]["grad_norm"])
    for new, old in ((got[0], params), (got[1]["m"], state["m"]),
                     (got[1]["v"], state["v"])):
        assert all(a is b for a, b in zip(_flat(new).values(),
                                          _flat(old).values()))


def test_trainer_step_donates_its_trees():
    """``Trainer``'s step writes its new parameters and moments over the
    tensors it holds, as the reference's step reuses the buffers it
    donates (``jax.jit(..., donate_argnums=(0, 1))``), so a step never
    holds two whole copies of the parameters and AdamW moments; the
    parameters equal an undonated step's bit for bit (on one thread: the
    CPU sums the ``embed`` gradient's rows in a thread-dependent
    order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _donated_trainer_step()
    finally:
        torch.set_num_threads(threads)


def _donated_trainer_step():
    cfg, _ = _cfgs()
    data = _data(cfg.vocab_size)
    batch = next(data)
    data.close()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(2),
                                     "cpu")
    copy = {k: v.clone() for k, v in layers.flatten(params).items()}
    trainer = Trainer(cfg, TrainConfig(steps=1, log_every=100),
                      iter([batch]), params=params, device="cpu")
    held = [layers.flatten(t) for t in (params, trainer.opt_state["m"],
                                         trainer.opt_state["v"])]
    trainer.run(1)
    for old, new in zip(held, (trainer.params, trainer.opt_state["m"],
                               trainer.opt_state["v"])):
        new = layers.flatten(new)
        assert old.keys() == new.keys()
        assert all(old[k] is new[k] for k in old)
    copy = layers.unflatten(copy)
    want, _, _ = make_train_step(cfg, TrainConfig())(
        copy, opt.init_opt_state(copy),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for name, p in layers.flatten(want).items():
        assert torch.equal(layers.flatten(trainer.params)[name], p), name


def test_global_norm_and_abstract_state():
    tree = _random_tree(3, "float32")
    np.testing.assert_allclose(np_(opt.global_norm(_to_port(tree))),
                               np.asarray(ref_opt.global_norm(
                                   _to_ref(tree))), rtol=1e-6)
    abstract = opt.abstract_opt_state(_to_port(tree))
    ref_abs = ref_opt.abstract_opt_state(_to_ref(tree))
    for part in ("m", "v"):
        for name, r in _flat(ref_abs[part]).items():
            a = _flat(abstract[part])[name]
            assert a.device.type == "meta" and a.dtype == torch.float32
            assert tuple(a.shape) == tuple(r.shape)
    assert abstract["step"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_bit_equal(dtype):
    """int8 round trip: bit-equal to the reference's (both round half to
    even); tensors under ``min_size`` untouched; ``none`` is identity."""
    rng = np.random.default_rng(7)
    g = {"w": rng.standard_normal((128, 96)).astype(np.float32),
         "h": (np.arange(-300, 300, dtype=np.float32) / 4.0).reshape(20, 30),
         "b": rng.standard_normal((8,)).astype(np.float32)}
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = compress_grads(_to_port(g, tdt), CompressionConfig(min_size=512))
    ref = ref_compress(_to_ref(g, jdt), RefCompression(min_size=512))
    for name in g:
        want = np.asarray(ref[name])
        got = out[name]
        if name == "b":
            assert got.dtype == tdt
        if want.dtype == ml_dtypes.bfloat16:
            want = want.view(np.uint16)
            got = got.view(torch.int16).numpy().view(np.uint16)
        else:
            got = got.numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    same = _to_port(g)
    assert compress_grads(same, CompressionConfig(kind="none")) is same
    assert compress_grads(same, None) is same


# ---------------------------------------------------------------------------
# train step, Trainer
# ---------------------------------------------------------------------------
def _data(vocab, batch=8, seq=64, seed=0, cls=PackedBatchIterator,
          src=SyntheticTokenSource):
    return cls(src(vocab, seed=seed), batch=batch, seq_len=seq)


def test_microbatch_matches_full_batch(ref_params):
    """Two microbatches summed in float32 give the full batch's loss and
    parameters (as the reference's scan, to float32 rounding)."""
    cfg, _ = _cfgs()
    data = _data(cfg.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
    data.close()
    params = transformer.params_from_reference(ref_params, cfg, "cpu")
    full = make_train_step(cfg, TrainConfig())(
        params, opt.init_opt_state(params), batch)
    micro = make_train_step(cfg, TrainConfig(microbatch=2))(
        params, opt.init_opt_state(params), batch)
    assert _rel(np_(micro[2]["loss"]), np_(full[2]["loss"])) <= 1e-5
    assert _rel(np_(micro[2]["grad_norm"]),
                np_(full[2]["grad_norm"])) <= 1e-4
    for name, p in layers.flatten(full[0]).items():
        assert _rel(np_(layers.flatten(micro[0])[name]), np_(p)) <= 1e-4


@pytest.mark.parametrize("microbatch", [0, 2])
def test_trainer_matches_reference(ref_params, microbatch):
    """5 steps of both Trainers from the same parameters on the same
    batches: every step's loss and grad norm (float32). The reference's
    batches are drawn first (its prefetch thread drops a batch when a
    step, or its first compile, keeps the queue full for a second)."""
    cfg, ref_cfg = _cfgs()
    ref_data = _data(cfg.vocab_size, seed=3, cls=RefPacked, src=RefSource)
    batches = [next(ref_data) for _ in range(5)]
    ref_data.close()
    tcfg = TrainConfig(steps=5, log_every=100, microbatch=microbatch)
    port = Trainer(cfg, tcfg, _data(cfg.vocab_size, seed=3),
                   params=transformer.params_from_reference(
                       ref_params, cfg, "cpu"), device="cpu")
    ref = RefTrainer(ref_cfg, RefTrainConfig(steps=5, log_every=100,
                                             microbatch=microbatch),
                     iter(batches),
                     params=jax.tree.map(jnp.asarray, ref_params))
    port.run(5)
    ref.run(5)
    for a, b in zip(port.history, ref.history):
        assert a["step"] == b["step"]
        assert _rel(a["loss"], b["loss"]) <= TOL, (a, b)
        assert _rel(a["grad_norm"], b["grad_norm"]) <= 1e-3, (a, b)
    assert len(port.history) == 5 and port.step == 5
    assert all(h["tokens"] == 8 * 64 for h in port.history)
    port.data.close()


def test_loss_decreases():
    """As ``tests/test_training.py::test_loss_decreases``: 30 steps of the
    bf16 reduced smollm from the port's own init."""
    cfg = reduced_config(ARCH)
    data = _data(cfg.vocab_size)
    tr = Trainer(cfg, TrainConfig(steps=30, log_every=100), data,
                 device="cpu")
    first = tr.run(1)["loss"]
    last = tr.run(29)["loss"]
    data.close()
    assert last < first - 0.1, (first, last)
    assert tr.straggler.n == 30 and tr.heartbeat.failed_workers() == []


def test_trainer_checkpoint_restart_is_bitwise(tmp_path):
    """A Trainer restored at step 3 continues with the same losses as the
    one that never stopped (same data order)."""
    cfg = reduced_config(ARCH)
    tcfg = TrainConfig(steps=5, log_every=100, checkpoint_every=3,
                       checkpoint_dir=str(tmp_path))
    a = Trainer(cfg, dataclasses.replace(tcfg, checkpoint_dir=None),
                _data(cfg.vocab_size, seed=4), device="cpu")
    a.run(5)
    data = _data(cfg.vocab_size, seed=4)
    b = Trainer(cfg, tcfg, data, device="cpu")
    b.run(3)
    c = Trainer(cfg, tcfg, data, device="cpu", seed=1)
    assert c.try_restore() and c.step == 3
    c.run(2)
    assert [h["loss"] for h in c.history] == \
        [h["loss"] for h in a.history[3:]]
    a.data.close()
    data.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
# the dtypes numpy cannot hold: ml_dtypes' type, torch's, the bits' views
_EXT = ((ml_dtypes.bfloat16, torch.bfloat16, np.int16, np.uint16),
        (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, np.uint8, np.uint8),
        (ml_dtypes.float8_e5m2, torch.float8_e5m2, np.uint8, np.uint8))


def _state_np(seed: int):
    """A parameter + optimizer state with bf16, float8, float32 and int32
    leaves (numpy; bf16 and float8 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 8)).astype(
                           ml_dtypes.bfloat16),
                       "scale": rng.standard_normal(8).astype(np.float32)},
            "opt": {"m": {"w": rng.standard_normal((8, 8)).astype(
                                np.float32)},
                    "q": rng.standard_normal(16).astype(
                        ml_dtypes.float8_e4m3fn),
                    "r": rng.standard_normal(4).astype(ml_dtypes.float8_e5m2),
                    "step": np.array(7, np.int32)}}


def _np_to_port(tree):
    def leaf(v):
        for np_dt, t_dt, view, _ in _EXT:
            if v.dtype == np_dt:
                return torch.from_numpy(np.array(v).view(view)).view(t_dt)
        return torch.from_numpy(np.array(v))
    return {k: _np_to_port(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def _bits(x) -> np.ndarray:
    for np_dt, t_dt, view, bits in _EXT:
        if isinstance(x, torch.Tensor) and x.dtype == t_dt:
            return x.view(torch.int16 if view == np.int16 else torch.uint8
                          ).numpy().view(bits)
        if not isinstance(x, torch.Tensor) and np.asarray(x).dtype == np_dt:
            return np.asarray(x).view(bits)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for name in fa:
        x, y = _bits(fa[name]), _bits(fb[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name


def test_checkpoint_port_to_reference_and_back(tmp_path):
    """The port writes, the reference restores bit for bit; the reference
    writes, the port restores bit for bit (bf16 as its uint16 bits under
    the name "bfloat16", float8 as uint8, float32, a 0-d int32 step)."""
    state = _state_np(0)
    CheckpointManager(str(tmp_path / "a"), async_save=False).save(
        5, _np_to_port(state), extra={"note": "port"})
    step, ref_state, extra = RefCkpt(str(tmp_path / "a")).restore()
    assert step == 5 and extra == {"note": "port"}
    _same_bits(jax.tree.map(np.asarray, ref_state), state)

    RefCkpt(str(tmp_path / "b"), async_save=False).save(
        6, jax.tree.map(jnp.asarray, state), extra={"note": "ref"})
    step, port_state, extra = CheckpointManager(str(tmp_path / "b")).restore(
        device="cpu")
    assert step == 6 and extra == {"note": "ref"}
    assert port_state["params"]["w"].dtype == torch.bfloat16
    assert port_state["opt"]["step"].dtype == torch.int32
    _same_bits(port_state, state)
    assert (tmp_path / "a" / "LATEST").read_text() == "step_000000000005"
    assert _manifest(tmp_path / "a" / "step_000000000005") == \
        _manifest(tmp_path / "b" / "step_000000000006")


def _manifest(vdir: Path):
    """A version's leaves and dtype names (what both packages read)."""
    meta = json.loads((vdir / "MANIFEST.json").read_text())
    return meta["leaves"], meta["dtypes"]


def test_checkpoint_gc_latest_and_async(tmp_path):
    """As ``tests/test_checkpoint.py``: keep_last GC, older versions still
    readable, the LATEST pointer, an async save visible after ``wait``,
    and the same directory listing as the reference's manager."""
    for name, mgr, conv in (
            ("port", CheckpointManager, _np_to_port),
            ("ref", RefCkpt, lambda t: jax.tree.map(jnp.asarray, t))):
        m = mgr(str(tmp_path / name), keep_last=2, async_save=False)
        for s in (1, 2, 3, 4):
            m.save(s, conv(_state_np(s)))
        assert m.all_steps() == [3, 4]
        assert (tmp_path / name / "LATEST").read_text().strip() == \
            "step_000000000004"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())
    m = CheckpointManager(str(tmp_path / "port"), keep_last=2)
    step3, state3, _ = m.restore(step=3, device="cpu")
    _same_bits(state3, _state_np(3))
    m.save(9, _np_to_port(_state_np(9)))
    m.wait()
    assert m.latest_step() == 9 and m.all_steps() == [4, 9]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")


def test_opt_state_from_reference(ref_params):
    cfg, _ = _cfgs()
    state = jax.tree.map(np.asarray, ref_opt.init_opt_state(
        jax.tree.map(jnp.asarray, ref_params)))
    state["m"] = jax.tree.map(lambda x: x + 1.5, state["m"])
    port = transformer.opt_state_from_reference(state, cfg, "cpu")
    _same_bits({"m": port["m"], "step": port["step"]},
               {"m": state["m"], "step": state["step"]})
    bad = dict(state, step=np.array(0, np.int64))
    with pytest.raises(ValueError, match="step"):
        transformer.opt_state_from_reference(bad, cfg, "cpu")


# ---------------------------------------------------------------------------
# data, ft
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("host_index", [0, 1])
def test_packed_batches_byte_equal(host_index):
    port = PackedBatchIterator(SyntheticTokenSource(512, seed=5,
                                                    mean_doc_len=40),
                               batch=4, seq_len=32, host_index=host_index,
                               host_count=2)
    ref = RefPacked(RefSource(512, seed=5, mean_doc_len=40), batch=4,
                    seq_len=32, host_index=host_index, host_count=2)
    for _ in range(4):
        a, b = next(port), next(ref)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    port.close()
    ref.close()
    src, ref_src = SyntheticTokenSource(512, seed=2), RefSource(512, seed=2)
    src.next_doc()
    ref_src.next_doc()
    assert src.state() == ref_src.state() == {"doc_idx": 1}
    resumed = SyntheticTokenSource(512, seed=2)
    resumed.restore(src.state())
    assert resumed.next_doc().tobytes() == ref_src.next_doc().tobytes()


def test_slow_consumer_loses_no_batch():
    """A consumer slower than the prefetch thread's one-second put
    timeout still gets the stream in order (the reference's thread drops
    the batch it holds there)."""
    fast = _data(512, batch=2, seq=16, seed=8)
    want = [next(fast)["tokens"].tobytes() for _ in range(4)]
    fast.close()
    slow = PackedBatchIterator(SyntheticTokenSource(512, seed=8), batch=2,
                               seq_len=16, prefetch=1)
    got = [next(slow)["tokens"].tobytes()]
    time.sleep(2.5)                   # the thread times out twice
    got += [next(slow)["tokens"].tobytes() for _ in range(3)]
    slow.close()
    assert got == want


def test_straggler_detector_and_remesh_match_reference():
    rng = np.random.default_rng(1)
    times = np.concatenate([rng.uniform(0.09, 0.11, 20), [0.5, 0.1, 0.31],
                            rng.uniform(0.09, 0.12, 10), [0.9]])
    a, b = monitor.StragglerDetector(0.3, 2.5), \
        ref_monitor.StragglerDetector(0.3, 2.5)
    assert [a.record(t) for t in times] == [b.record(t) for t in times]
    assert a.flagged == b.flagged and a.flagged
    assert a.ewma == b.ewma and a.n == b.n
    for n in (16, 31, 240, 480, 512, 1000):
        for mp, pods in ((16, 1), (16, 2), (8, 2), (4, 1)):
            assert monitor.plan_remesh(n, model_parallel=mp, pods=pods) \
                .__dict__ == ref_monitor.plan_remesh(
                    n, model_parallel=mp, pods=pods).__dict__
    with pytest.raises(RuntimeError):
        monitor.plan_remesh(8, model_parallel=16)
    hb = monitor.HeartbeatMonitor(timeout_s=0.0)
    hb.beat(1, worker=3)
    assert hb.failed_workers() in ([], [3])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        from repro_torch.obs.ewma import EwmaAnomaly
        assert monitor.EwmaAnomaly is EwmaAnomaly
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    with pytest.raises(AttributeError):
        monitor.Nothing


# ---------------------------------------------------------------------------
# launchers and the example, on the CPU at reduced size
# ---------------------------------------------------------------------------
def test_launchers_and_example_run_on_cpu(tmp_path, capsys):
    """``launch/train.py`` (with microbatches, compression, a checkpoint
    and a resumed run), ``launch/serve.py`` and ``examples_torch/
    train_smollm.py`` at reduced size, in this process."""
    from repro_torch.launch import serve, train
    train.main(["--reduced", "--steps", "4", "--batch", "4", "--seq", "32",
                "--log-every", "2", "--microbatch", "2", "--compress-grads",
                "--ckpt", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 4: loss=" in out and "tokens/s" in out and "n/a" in out
    train.main(["--reduced", "--steps", "6", "--batch", "4", "--seq", "32",
                "--ckpt", str(tmp_path), "--resume", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: step=10" in out
    serve.main(["--reduced", "--requests", "3", "--max-new", "4",
                "--device", "cpu"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "train_smollm", ROOT / "examples_torch" / "train_smollm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--steps", "4", "--batch", "2", "--seq", "32", "--layers",
                  "2", "--d-model", "64", "--vocab", "512", "--device",
                  "cpu"])
    out = capsys.readouterr().out
    assert "restored at step 2" in out and "final: step=4" in out


def test_launchers_raise_without_gpu(monkeypatch):
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (train, serve):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(reduced_config(ARCH), TrainConfig(), iter([]))
