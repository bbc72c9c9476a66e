"""The training step of every family but smollm-360m sharded as the
reference shards it, on real gloo ranks on the CPU, against the
unsharded step: phase 19's reduced-width cases (``chip_smoke.
sharded_cases``).

- Each family's ``configs.reduced_config`` in float32, its parameters
  seeded leaf by leaf (``chip_smoke.case_leaves``: every rank draws the
  same), B=4 x S=64, on a (2, 2) ("data", "model") mesh with sequence
  parallelism off and on; the two MoE families also on (2, 2, 1)
  ("pod", "data", "model"), where the batch shards over two mesh dims;
  and reduced grok-1 with 3 experts (``chip_smoke.expert_tp_config``),
  which ``model`` = 2 does not divide, so the experts' d_ff shards over
  it (expert-internal TP, grok's route on 16 cards), off and on. One
  world of 4 processes a mesh, every case of the mesh inside; both run
  at once, while the test's process runs the unsharded steps and the
  reference. mistral-nemo-12b, nemotron-4-15b and qwen3-32b run
  smollm-360m's block (GQA, RMSNorm, a dense FFN), so their
  sequence-parallel cases are left to the card (``CARD_ONLY``), which
  keeps the file's time down.
- Two AdamW steps, each held against the unsharded step at equal inputs
  (``chip_smoke.sharded_checks``): loss and gradient within 1e-5 of
  each leaf's largest magnitude, the parameters after within 1e-3 but
  for isolated AdamW sign flips (phase 18's rule), the MoE router's
  expert sets equal but at near-ties below 1e-6.
- Step 1's loss and gradient against the reference's unsharded
  ``jax.value_and_grad`` at the same parameters within
  ``test_torch_grads``' 1e-4.
- The repaired faults: under expert-internal TP the MoE buffer's
  gradient arrived sharded on the expert dim, which the [E * C, D]
  view's backward cannot take where ``data`` does not divide E
  (``models/ffn.py``; a fake (2, 2) world's train cell holds it);
  ``adamw_update`` returned a DTensor parameter in its gradient's
  placements where the two differed (``training/optimizer.py``).
- Phase 19's published-width comparison (each gradient shard against
  the same slice of the unsharded gradient, a block of rows at a time)
  on two CPU thread ranks.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import _torch_elastic as worlds
import chip_smoke as cs
from benchmarks_torch.common import spawn_ranks
from repro.configs import archs as ref_archs
from repro.models import loss_fn as ref_loss_fn
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import layers
from repro_torch.parallel import sharding as shd
from test_torch_grads import assert_leaves_close

TOL, REF_TOL = 1e-5, 1e-4
REDUCED_PARTS = tuple(p for p in cs.SHARDED_PARTS if p != "published")
#: run on the card only (phase 19), not here
CARD_ONLY = tuple(f"{a} 2x2 sp" for a in ("mistral-nemo-12b",
                                          "nemotron-4-15b", "qwen3-32b"))
REF_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(ref_loss_fn),
                             static_argnums=2)


def _ref_config(arch):
    """The reference's config of a phase 19 case (float32)."""
    if arch == cs.EXPERT_TP:
        cfg = ref_archs.reduced_config("grok-1-314b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=3))
    else:
        cfg = ref_archs.reduced_config(arch)
    return dataclasses.replace(cfg, dtype="float32")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _ref_batch(case):
    """The case's first batch as the reference takes it (bf16 features:
    the batch holds bf16 values)."""
    return {k: jnp.asarray(v, jnp.bfloat16 if k in ("patches", "frames")
                           else jnp.int32)
            for k, v in cs.sharded_batches(case)[0].items()}


def _plan():
    """Phase 19's reduced cases (``chip_smoke.sharded_plan``) without
    CARD_ONLY, one world a mesh (a world's processes plan each DTensor op
    once for both settings of sequence parallelism): [(mesh key,
    cases)]."""
    worlds = {}
    for _, key, cases in cs.sharded_plan(REDUCED_PARTS):
        worlds.setdefault(key, []).extend(
            c for c in cases if c["name"] not in CARD_ONLY)
    return list(worlds.items())


def _names():
    return [c["name"] for _, cases in _plan() for c in cases]


@pytest.fixture(scope="module")
def runs():
    """Every reduced case: its ranks' records, its unsharded run with the
    equal-input replays, and the reference's step-1 loss and gradient."""
    plan = _plan()
    with ThreadPoolExecutor(len(plan)) as pool:
        futures = [(cases, pool.submit(spawn_ranks, functools.partial(
            worlds.families_world, cases=cases), 4, "cpu",
            mesh=cs.SHARDED_MESHES[key])) for key, cases in plan]
        # the unsharded runs and the reference while the worlds run
        unsharded, ref = {}, {}
        for case in (c for _, cases in plan for c in cases):
            arch = case["arch"]
            if arch not in unsharded:
                unsharded[arch] = cs.unsharded_family(case, "cpu")
                params = {k: jnp.asarray(v.numpy()) for k, v in
                          cs.case_leaves(case, "cpu")}
                loss, grads = REF_VALUE_AND_GRAD(
                    layers.unflatten(params), _ref_batch(case),
                    _ref_config(arch))
                ref[arch] = (float(loss), _flat(grads))
        recs = [(cases, f.result()) for cases, f in futures]
    out = {}
    for cases, ranks in recs:
        for case in cases:
            got = [r[case["name"]] for r in ranks]
            want = cs.with_replays(case, unsharded[case["arch"]], got[0],
                                   "cpu")
            out[case["name"]] = (case, got, want, ref[case["arch"]])
    return out


@pytest.mark.parametrize("name", _names())
def test_sharded_steps_hold_to_the_unsharded_steps(runs, name):
    case, got, want, _ = runs[name]
    out = cs.sharded_checks(case, want, got, TOL, on_card=False)
    assert out["trajectory"]["loss"] <= TOL
    if case["cfg"].moe is not None:
        assert out["routing"]["calls"] > 0


@pytest.mark.parametrize("name", _names())
def test_sharded_gradient_matches_the_reference(runs, name):
    """Step 1's sharded loss and gradient (gathered) against the
    reference's unsharded ``value_and_grad`` at the same parameters."""
    case, got, _, (ref_loss, ref_grads) = runs[name]
    assert abs(got[0]["losses"][0] - ref_loss) <= REF_TOL * abs(ref_loss)
    assert_leaves_close(ref_grads, got[0]["grads"][0], name, tol=REF_TOL)


def test_expert_tp_shards_the_experts_d_ff():
    """3 experts on ``model`` = 2: the experts' d_ff over ``model``
    (``sharding.py``'s expert-internal TP), the expert dim whole; 4
    experts shard over it (EP)."""
    cfg = cs.expert_tp_config()
    mesh = {"data": 2, "model": 2}
    moe = shd.param_shardings(cfg, mesh)["layers"]["moe"]
    assert shd.logical_rules(cfg, mesh)["expert_mlp"] == "model"
    assert moe["w1"] == (None, None, "data", "model")
    assert moe["w2"] == (None, None, "model", "data")
    ep = shd.param_shardings(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4)), mesh)["layers"]["moe"]
    assert ep["w1"] == (None, "model", "data")


@pytest.fixture
def fake_world():
    """torch's fake process group for a DeviceMesh of fake ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    opened = not dist.is_initialized()
    if opened:
        dist.init_process_group("fake", rank=0, world_size=4,
                                store=FakeStore())
    yield
    if opened:
        dist.destroy_process_group()


@pytest.mark.parametrize("sp", [False, True])
def test_expert_tp_train_step_places_on_a_fake_mesh(fake_world, sp):
    """Reduced grok-1 with 3 experts, a train cell on a fake (2, 2)
    world: without the MoE buffer's gradient pin the backward raises in
    DTensor's ``aten.view`` (an expert dim of 3 sharded over ``data``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = dataclasses.replace(reduced_config("grok-1-314b"),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           num_experts=3))
    mesh = device_mesh((2, 2), ("data", "model"), "cpu")
    fake = FakeTensorMode()
    fn, args, _ = specs.build_cell(
        "grok-1-314b", "train_4k", mesh, cfg=cfg,
        shape=dict(seq=64, batch=4, kind="train"), device="cpu",
        fake_mode=fake)
    rec = dryrun.measure(fn, args, fake, mesh, sequence_parallel=sp)
    assert rec["jaxpr"]["dot_flops"] > 0


def _adamw_world(mesh):
    """Two AdamW steps on DTensor leaves (one sharded, its gradient in
    another placement; one replicated) and on the same plain tensors:
    both gathered, with the leaves' placements."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    rng = np.random.default_rng(34)
    full = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in (("w", (8, 6)), ("b", (6,)), ("gw", (8, 6)),
                         ("gb", (6,)))}
    place = {"w": [Replicate(), Shard(1)], "b": [Replicate(), Replicate()]}
    grad_place = {"w": [Replicate(), Shard(0)], "b": [Replicate(),
                                                        Replicate()]}
    cfg = AdamWConfig(clip_norm=1e9)        # no clip: the same scale, 1
    dt = {k: distribute_tensor(full[k], mesh, place[k], src_data_rank=None)
          for k in place}
    plain = {k: full[k].clone() for k in place}
    dopt, popt = init_opt_state(dt), init_opt_state(plain)
    for _ in range(2):
        g = {k: distribute_tensor(full["g" + k], mesh, grad_place[k],
                                  src_data_rank=None) for k in place}
        dt, dopt, _ = adamw_update(dt, g, dopt, cfg)
        plain, popt, _ = adamw_update(
            plain, {k: full["g" + k] for k in place}, popt, cfg)
    return ({k: (v.full_tensor(), tuple(v.placements)) for k, v in dt.items()},
            {k: (v.full_tensor(), tuple(v.placements))
             for k, v in dopt["m"].items()}, plain, popt["m"], place)


def test_adamw_on_dtensor_leaves_is_the_plain_update():
    """``adamw_update`` on DTensor leaves (run on their local shards) gives
    the plain update's bits, each leaf and moment in its parameter's
    placements, a gradient in another placement brought to them first."""
    import torch
    out = cs.thread_ranks(_adamw_world, 2, device="cpu",
                          mesh=((1, 2), ("data", "model")))
    for dt, dm, plain, pm, place in out:
        for k in plain:
            assert torch.equal(dt[k][0], plain[k]), k
            assert torch.equal(dm[k][0], pm[k]), k
            assert list(dt[k][1]) == place[k] and list(dm[k][1]) == place[k]


def _published_style_case():
    """Reduced hymba-1.5b (SSM and attention heads) as phase 19 holds a
    published-width case: the step-1 gradient only,
    on (1, 2), each leaf compared shard by shard."""
    case = cs.sharded_cases("reduced", archs=("hymba-1.5b",),
                            expert_tp=False)[0]
    return dict(case, name="hymba-1.5b 1x2", mesh="1x2", steps=0,
                width="published")


def test_published_width_checks_hold_shard_by_shard(monkeypatch):
    """Phase 19's published-width comparison (``local_agreement`` in
    blocks of rows on the device, ``finite_scale`` once per leaf of the
    unsharded gradient) on two CPU thread ranks, its blocks cut to 100
    elements so that the large leaves are split: the sharded gradient
    holds within 1e-5."""
    monkeypatch.setattr(cs, "CHUNK_ELEMENTS", 100)
    case = _published_style_case()
    want = cs.unsharded_family(case, "cpu")
    case["want"] = want["want"]
    assert case["want"]["layer_01/ssm/in_proj"].numel() > \
        4 * cs.CHUNK_ELEMENTS
    recs = cs.thread_ranks(
        functools.partial(cs.sharded_world, cases=[case], device="cpu"),
        2, device="cpu", mesh=cs.SHARDED_MESHES["1x2"])
    out = cs.sharded_checks(case, want, [r[case["name"]] for r in recs],
                            TOL, on_card=False)
    assert out["grads"][0] <= TOL and out["nonfinite"] == []


def _agreement_world(mesh):
    """``local_agreement`` of DTensor leaves in each placement kind
    (sharded on dim 0 and 1, replicated, partial, 0-d) against their
    whole values, against them with one element changed on the second
    rank's shard, and with one of those made NaN."""
    import torch
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    whole = {"rows": torch.arange(60.0).reshape(12, 5),
             "cols": torch.arange(48.0).reshape(4, 12) / 7,
             "rep": torch.ones(9), "scalar": torch.tensor(2.5)}
    place = {"rows": [Replicate(), Shard(0)], "cols": [Replicate(), Shard(1)],
             "rep": [Replicate(), Replicate()],
             "scalar": [Replicate(), Replicate()]}
    grads = {k: distribute_tensor(v, mesh, place[k], src_data_rank=None)
             for k, v in whole.items()}
    # a partial sum: each rank holds half the value
    grads["part"] = DTensor.from_local(torch.full((6,), 0.5), mesh,
                                       [Replicate(), Partial()])
    want = dict(whole, part=torch.ones(6))
    out = [cs.local_agreement(grads, want, "cpu")]
    for bad in (1.0, float("nan")):
        w = {k: v.clone() for k, v in want.items()}
        w["rows"][-1, -1] += bad
        w["cols"][-1, -1] += bad
        out.append(cs.local_agreement(grads, w, "cpu"))
    return out


def test_local_agreement_compares_each_shard_in_blocks(monkeypatch):
    monkeypatch.setattr(cs, "CHUNK_ELEMENTS", 10)
    exact, moved, nan = cs.thread_ranks(
        _agreement_world, 2, device="cpu",
        mesh=((1, 2), ("data", "model")))[1]
    assert exact == {k: (True, 0.0) for k in exact}
    assert moved["rows"] == (True, 1.0) and moved["cols"] == (True, 1.0)
    assert nan["rows"] == (False, 0.0) and nan["cols"][0] is False
    assert moved["rep"] == nan["rep"] == (True, 0.0)


def test_finite_scale_reads_a_leaf_in_blocks(monkeypatch):
    import torch
    monkeypatch.setattr(cs, "CHUNK_ELEMENTS", 7)
    x = torch.linspace(-3, 2, 50).reshape(5, 10)
    assert cs.finite_scale(x) == (3.0, False)
    x[4, 9] = float("inf")
    x[0, 0] = 0.5
    assert cs.finite_scale(x) == (float(x[0, 1].abs()), True)
    assert cs.finite_scale(torch.tensor(-4.0)) == (4.0, False)
