"""The elastic restart of the port against the JAX package, on the CPU:
sharded checkpoints (``CheckpointManager.save`` of ``DTensor``s,
``restore(shardings=)`` onto a ``DeviceMesh``) and training steps whose
tensors are sharded over real ranks.

The reference trains on a (2, 2) ``("data", "model")`` mesh, saves,
calls ``plan_remesh``, restores onto (1, 2) and trains on
(``tests/test_elastic.py``), but its sharded step fails on this tree
(ROADMAP.md, known limits), so the port's sharded steps are held to the
reference's unsharded ``make_train_step`` on the same float32
parameters and batches: reduced smollm-360m, 4 ranks on (2, 2) for 3
steps, a save, then 2 ranks on (1, 2) restored with ``shardings=`` for
2 steps; losses and parameters within ``TOL`` (1e-4, as
``tests/test_torch_training.py``). The restored state, gathered, must
equal the files bit for bit, and both packages must restore what the
other wrote, sharded or not, bit for bit. The flash operators' forward
and backward on real-rank shards (batch, KV heads, both) must equal the
plain versions on the whole tensors. The ranks are processes over gloo
(``benchmarks_torch.common.spawn_ranks``); the worlds are
``tests/_torch_elastic.py``'s, which run ``chip_smoke.elastic_world``
(phase 18) on the CPU.
"""
import concurrent.futures
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_elastic as worlds
import chip_smoke as cs
from benchmarks_torch.common import spawn_ranks
from repro.checkpoint.manager import CheckpointManager as RefCkpt
from repro.configs import reduced_config as ref_reduced_config
from repro.models import init_params as ref_init_params
from repro.training import optimizer as ref_opt
from repro.training.train_loop import TrainConfig as RefTrainConfig
from repro.training.train_loop import make_train_step as ref_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import PackedBatchIterator, SyntheticTokenSource
from repro_torch.ft.monitor import plan_remesh
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.spec import NamedSharding, named_shardings

ARCH = "smollm-360m"
TOL = 1e-4
BATCH, SEQ, DATA_SEED = 4, 32, 3
CASE = "f32_reduced"
#: the flash operators: the plain versions on shards against the whole
FLASH_TOL = 1e-6


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


def _mixed_state():
    """bf16, float8, float32 and int32 leaves (numpy; bf16 and float8 as
    ml_dtypes), in ``_torch_elastic.MIXED_SPECS``' tree."""
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((8, 8)).astype(
                           ml_dtypes.bfloat16),
                       "scale": rng.standard_normal(8).astype(np.float32)},
            "opt": {"m": {"w": rng.standard_normal((8, 8)).astype(
                                np.float32)},
                    "q": rng.standard_normal(16).astype(
                        ml_dtypes.float8_e4m3fn),
                    "r": rng.standard_normal(4).astype(ml_dtypes.float8_e5m2),
                    "step": np.array(7, np.int32)}}


def _bits_np(x) -> np.ndarray:
    """A numpy leaf's bits as a save writes them."""
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    if x.dtype.name.startswith("float8"):
        return x.view(np.uint8)
    return x


def _ref_state(x=1.5):
    """``tests/test_checkpoint.py::_state``."""
    return {"params": {"w": jnp.full((8, 8), x, jnp.bfloat16),
                       "scale": jnp.full((8,), x, jnp.float32)},
            "opt": {"m": {"w": jnp.zeros((8, 8), jnp.float32)}}}


def _reference_steps(params_np, batches):
    """The reference's unsharded ``make_train_step`` (float32) over the
    batches: losses, grad norms and the parameters after each world."""
    ref_cfg = dataclasses.replace(ref_reduced_config(ARCH), dtype="float32")
    step = ref_train_step(ref_cfg, RefTrainConfig())
    params = jax.tree.map(jnp.asarray, params_np)
    opt = ref_opt.init_opt_state(params)
    out = {"losses": [], "norms": [], "params": {}}
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt,
                              {k: jnp.asarray(v) for k, v in b.items()})
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        if i + 1 in (cs.ELASTIC_STEPS[0], sum(cs.ELASTIC_STEPS)):
            out["params"][i + 1] = _flat(jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds (4 ranks on (2, 2), then ``plan_remesh``'s 2 on
    (1, 2)) from the reference's float32 parameters, and the reference's
    unsharded steps on the same batches."""
    root = tmp_path_factory.mktemp("elastic")
    ref_cfg = dataclasses.replace(ref_reduced_config(ARCH), dtype="float32")
    params_np = jax.tree.map(np.asarray, jax.jit(
        ref_init_params, static_argnums=0)(ref_cfg, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(reduced_config(ARCH), dtype="float32")
    cases = cs.elastic_cases([(CASE, cfg, BATCH, SEQ)], control=False)
    cases[0]["params"] = params_np
    data = PackedBatchIterator(SyntheticTokenSource(cfg.vocab_size,
                                                    seed=DATA_SEED),
                               batch=BATCH, seq_len=SEQ)
    batches = [next(data) for _ in range(sum(cs.ELASTIC_STEPS))]
    data.close()
    mixed = _mixed_state()
    RefCkpt(str(root / "ref_mixed"), async_save=False).save(
        6, jax.tree.map(jnp.asarray, mixed), extra={"note": "ref"})
    RefCkpt(str(root / "reshard"), async_save=False).save(1, _ref_state())
    plan = plan_remesh(2, model_parallel=2)
    # the reference's steps in a thread while the ranks run
    ref = concurrent.futures.ThreadPoolExecutor(1).submit(
        _reference_steps, params_np, batches)
    first = spawn_ranks(functools.partial(
        worlds.first_world, cases=cases, root=str(root / "train"),
        mixed=worlds.to_port(mixed), port_dir=str(root / "port_mixed")),
        4, "cpu", timeout=120, mesh=cs.ELASTIC_MESH)
    second = spawn_ranks(functools.partial(
        worlds.second_world, cases=cases, root=str(root / "train"),
        ref_dir=str(root / "ref_mixed"), reshard_dir=str(root / "reshard")),
        plan.devices, "cpu", timeout=120,
        mesh=((plan.data, plan.model), cs.ELASTIC_MESH[1]))
    return types.SimpleNamespace(
        root=root, first=first, second=second, mixed=mixed, plan=plan,
        ref=ref.result())


# ---------------------------------------------------------------------------
# the training steps of both worlds against the reference's
# ---------------------------------------------------------------------------
def _records(run, world):
    return [r["elastic"][CASE] for r in getattr(run, world)]


def test_elastic_restart_losses_match_reference(run):
    """Every rank's losses of both worlds (5 steps) equal the reference's
    unsharded steps within TOL, their grad norms (``global_norm`` over
    every shard) within 1e-3, and the restart resumes at step 3."""
    assert (run.plan.data, run.plan.model, run.plan.devices) == (1, 2, 2)
    for a, b in zip(_records(run, "first"), _records(run, "second")):
        assert a["start"] == 0 and b["start"] == cs.ELASTIC_STEPS[0]
        losses = a["losses"] + b["losses"]
        norms = a["grad_norms"] + b["grad_norms"]
        assert len(losses) == sum(cs.ELASTIC_STEPS)
        for got, want in zip(losses, run.ref["losses"]):
            assert _rel(got, want) <= TOL, (losses, run.ref["losses"])
        for got, want in zip(norms, run.ref["norms"]):
            assert _rel(got, want) <= 1e-3, (norms, run.ref["norms"])


@pytest.mark.parametrize("step", cs.ELASTIC_STEPS[:1] + (
    sum(cs.ELASTIC_STEPS),))
def test_elastic_restart_params_match_reference(run, step):
    """The parameters each world saved (gathered by the save) equal the
    reference's after the same steps: each leaf within TOL of its
    largest magnitude."""
    _, state, _ = CheckpointManager(str(run.root / "train" / CASE)).restore(
        step, device="cpu")
    got = {k: v.numpy() for k, v in _flat(state["params"]).items()}
    want = run.ref["params"][step]
    assert set(got) == set(want)
    for k, w in want.items():
        assert _rel(got[k], w) <= TOL, k


def test_restored_state_bit_equal_to_saved(run):
    """Each restart rank restored every leaf of the step-3 version as a
    ``DTensor`` placed by ``param_shardings`` / ``opt_state_shardings``
    on (1, 2), and the gathered state equals the files bit for bit
    (``chip_smoke.restored_equals_files``)."""
    cfg = dataclasses.replace(reduced_config(ARCH), dtype="float32")
    # params, m and v a leaf each, and the step
    n = 3 * len(_flat(shd.param_shardings(cfg, {"data": 1, "model": 2}))) + 1
    for rec in _records(run, "second"):
        assert rec["restored"] == n


def test_training_checkpoint_restored_by_reference(run):
    """The reference restores the first world's sharded save, bit for
    bit equal to the port's own unsharded restore of it."""
    vdir = run.root / "train" / CASE
    step, ref_state, _ = RefCkpt(str(vdir)).restore(cs.ELASTIC_STEPS[0])
    _, port_state, _ = CheckpointManager(str(vdir)).restore(
        cs.ELASTIC_STEPS[0], device="cpu")
    ref_flat = _flat(jax.tree.map(np.asarray, ref_state))
    port_flat = _flat(port_state)
    assert step == cs.ELASTIC_STEPS[0] and set(ref_flat) == set(port_flat)
    for k, v in port_flat.items():
        assert ref_flat[k].dtype == v.numpy().dtype, k
        assert np.array_equal(ref_flat[k], v.numpy()), k


def test_ranks_agree_and_no_kernel_on_the_cpu(run):
    """Every rank of a world sees the same losses; on the CPU the flash
    operators run their plain versions, so no rank counts a launch."""
    for world in ("first", "second"):
        recs = _records(run, world)
        assert len({tuple(r["losses"]) for r in recs}) == 1
        assert sorted(r["rank"] for r in recs) == list(range(len(recs)))
        assert all(not r["launches"] for r in recs)


# ---------------------------------------------------------------------------
# checkpoints across the packages, sharded
# ---------------------------------------------------------------------------
def test_sharded_save_restored_by_reference_bit_for_bit(run):
    """The port's synchronous save of a state sharded over (2, 2) (bf16,
    float8, float32, a 0-d int32 step; shards over one mesh dim, both
    or none) is the reference's layout: the reference restores it bit
    for bit."""
    assert all(r["saved"] for r in run.first)
    step, state, extra = RefCkpt(str(run.root / "port_mixed")).restore()
    assert step == 5 and extra == {"note": "port"}
    got, want = _flat(jax.tree.map(np.asarray, state)), _flat(run.mixed)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(_bits_np(got[k]), _bits_np(w)), k


def test_reference_save_restored_sharded_bit_for_bit(run):
    """The reference's save of the same state, restored by every rank of
    (1, 2) with ``shardings=``: each leaf a DTensor placed as asked, and
    gathered bit for bit the state (bf16 as its uint16 bits under
    "bfloat16", float8 as uint8)."""
    want = _flat(run.mixed)
    for rank in run.second:
        got = rank["ref_mixed"]
        assert got["step"] == 6 and got["extra"] == {"note": "ref"}
        assert got["placed"]
        assert set(got["bits"]) == set(want)
        for k, w in want.items():
            arr, name = got["bits"][k]
            assert name == str(w.dtype), k
            assert np.array_equal(arr, _bits_np(w)), k


def test_restore_shardings_on_two_rank_mesh(run):
    """``tests/test_checkpoint.py::test_elastic_reshard_restore``'s state
    restored onto the 2-rank mesh: ``w`` sharded by rows (4 of 8 on each
    rank) still reads 1.5; ``scale``, without a sharding, loads whole on
    the device asked for; ``m`` replicated."""
    for rank in run.second:
        r = rank["reshard"]
        assert r["w11"] == 1.5 and r["w_local"] == (4, 8)
        assert r["scale_type"] == "Tensor" and r["scale"] == [1.5] * 8
        assert r["m_type"] == "DTensor"


def test_restore_shardings_on_one_rank_mesh(tmp_path):
    """The same restore onto a (1,) mesh over a one-rank gloo group, as
    the reference's test restores onto ``jax.make_mesh((1,), ("data",))``
    (every placement ``Replicate``)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import device_mesh
    RefCkpt(str(tmp_path), async_save=False).save(1, _ref_state())
    opened = not dist.is_initialized()
    if opened:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        mesh = device_mesh((1,), ("data",), "cpu")
        sh = {"params": {"w": NamedSharding(mesh, ()),
                         "scale": NamedSharding(mesh, ())},
              "opt": {"m": {"w": NamedSharding(mesh, ())}}}
        _, state, _ = CheckpointManager(str(tmp_path)).restore(shardings=sh)
        w = state["params"]["w"]
        assert isinstance(w, DTensor) and tuple(w.placements) == (
            Replicate(),)
        assert w.dtype == torch.bfloat16 and float(w[1, 1]) == 1.5
        assert float(state["params"]["scale"].to_local()[0]) == 1.5
        _, state, _ = CheckpointManager(str(tmp_path)).restore(
            shardings={"params": {"w": NamedSharding(mesh, ("data",))}},
            device="cpu")
        assert isinstance(state["params"]["w"], DTensor)
        assert type(state["opt"]["m"]["w"]) is torch.Tensor
    finally:
        if opened:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the flash operators on real-rank shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["batch", "heads", "batch+heads"])
def test_flash_operators_on_real_rank_shards(run, case):
    """Each rank of (2, 2) ran the flash operators' forward and backward
    on its local shards (sharded on the batch over ``data``, the KV heads
    over ``model``, or both); gathered, they equal the plain versions on
    the whole tensors within FLASH_TOL. The fake process group moved no
    data; these ranks did."""
    b, s, kvh, g, dh = cs.SHARD_FLASH[torch.float32]
    local = {"batch": (b // 2, s, kvh, g, dh),
             "heads": (b, s, kvh // 2, g, dh),
             "batch+heads": (b // 2, s, kvh // 2, g, dh)}[case]
    for rank in run.first:
        errs, launches = rank["flash"]
        assert errs[case]["local"] == local and not launches
        for k in ("forward", "dq", "dk", "dv"):
            assert errs[case][k] <= FLASH_TOL, (case, k, errs[case])


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
def test_named_shardings_pair_specs_with_mesh():
    """``named_shardings`` pairs every spec of a tree with one mesh; a
    ``NamedSharding``'s placements are ``placements(spec, mesh)``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    tree = named_shardings(mesh, {"a": ("model",), "b": {"c": (None,
                                                               "data")},
                                  "d": ()})
    assert tree["a"] == NamedSharding(mesh, ("model",))
    assert tree["a"].placements == (Replicate(), Shard(0))
    assert tree["b"]["c"].placements == (Shard(1), Replicate())
    assert tree["d"].placements == (Replicate(), Replicate())


def test_spawn_ranks_wants_a_card_a_rank():
    """Card ranks run over NCCL, one a card: more ranks than cards raise
    before any process starts."""
    with pytest.raises(ValueError, match="want a card each"):
        spawn_ranks(print, torch.cuda.device_count() + 1, "cuda")


def test_param_agreement_counts_flips_and_gradients_below_the_gap():
    """Phase 18's parameter check: the elements past the limit, per leaf,
    and their largest difference in lr x steps; beside them, the
    elements whose unsharded gradient at their first nonzero update is
    nonzero and below the leaf's sharded-unsharded gradient gap, and the
    worst leaf over every other element (one that no step gave a
    gradient included)."""
    from repro_torch.training.optimizer import AdamWConfig
    want = {"w": np.array([1.0, 1.0, 1.0, 1.0])}
    got = {"w": np.array([1.0, 1.1, 1.1, 1.0])}
    first = {"w": np.array([0.5, 1e-9, 0.0, 0.5])}
    p = cs.param_agreement(got, want, 2, first, {"w": 1e-8})
    assert p["beyond"] == {"w": (2, 4)}
    assert p["reach"] == pytest.approx(0.1 / (2 * AdamWConfig().lr))
    assert p["below_gap"] == {"w": (1, 1)}
    assert p["worst"][0] == pytest.approx(0.1)
    assert p["worst_above_gap"][0] == pytest.approx(0.1)
    p = cs.param_agreement({"w": np.array([1.0, 1.1, 1.0, 1.0])}, want, 1,
                           first, {"w": 1e-8})
    assert p["worst_above_gap"] == (0.0, "w") and p["below_gap"] == {
        "w": (1, 1)}
