"""The port's sharding rules and activation constraints against the JAX
package's, on the CPU.

``repro_torch.parallel.sharding`` gives the reference's specs for every
architecture, in train and serve mode, for every parameter, the batch
and every cache leaf, on the (1, 1), (2, 2), (16, 16) and (2, 16, 16)
meshes (the reference's side over ``jax.sharding.AbstractMesh``; a spec
compares equal to ``tuple(PartitionSpec)``). The constraints pin the
spec the reference pins (its ``with_sharding_constraint`` captured by a
monkeypatch: its own mesh path raises on this tree); on a DTensor they
redistribute to it, and on a plain tensor or without a mesh they return
the tensor itself, so the models' outputs and gradients are bit-equal
with and without ``activation_mesh``. The reference's
``tests/test_sharding.py`` cases are mirrored. DeviceMeshes run over
torch's fake process group, opened for this module and closed after.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import abstract_params as ref_abstract_params
from repro.models import transformer as ref_tf
from repro.parallel import constraints as ref_con
from repro.parallel import sharding as ref_shd
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.parallel import constraints as con
from repro_torch.parallel import sharding as shd

ARCHS = sorted(REF_ARCHS)
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x1", "2x2", "16x16", "2x16x16"]


def _ref_mesh(shape, names):
    return AbstractMesh(shape, names)


def _port_mesh(shape, names):
    return dict(zip(names, shape))


def _flat_ref(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_ref(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.spec)
    return out


@pytest.fixture(scope="module")
def fake_world():
    """torch's fake process group for this module's DeviceMeshes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    opened = not dist.is_initialized()
    if opened:
        dist.init_process_group("fake", rank=0, world_size=512,
                                store=FakeStore())
    yield
    if opened:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# sharding rules: every architecture, both modes, four meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_rule_specs_match_reference(arch, mesh):
    rm, pm = _ref_mesh(*mesh), _port_mesh(*mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for mode in ("train", "serve"):
        assert shd.logical_rules(cfg, pm, mode) == \
            ref_shd.logical_rules(rcfg, rm, mode)
        want = _flat_ref(ref_shd.param_shardings(rcfg, rm, mode))
        got = layers.flatten(shd.param_shardings(cfg, pm, mode))
        assert got == want, (arch, mode)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_specs_match_reference(mesh):
    rm, pm = _ref_mesh(*mesh), _port_mesh(*mesh)
    for shape in [(256, 4096), (32, 32768), (128, 1), (1, 1), (3, 5),
                  (2, 256, 160), (16, 2304, 1152), (512, 7, 9)]:
        assert shd.batch_sharding(pm, shape) == \
            tuple(ref_shd.batch_sharding(rm, shape).spec), shape


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    """Every decode-cache leaf at the decode_32k and long_500k shapes (the
    port's cache built on fake tensors, the reference's by eval_shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rm, pm = _ref_mesh(*mesh), _port_mesh(*mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for batch, seq in ((128, 32768), (1, 524288)):
        rcache = jax.eval_shape(
            lambda: ref_tf.init_cache(rcfg, batch, seq, jnp.bfloat16))
        want = _flat_ref(ref_shd.cache_shardings(rcfg, rm, rcache))
        with FakeTensorMode():
            cache = tf.init_cache(cfg, batch, seq, torch.bfloat16, "cpu")
        got = layers.flatten(shd.cache_shardings(cfg, pm, cache))
        assert got == want, (arch, batch, seq)


def test_opt_state_specs_match_reference():
    rm, pm = _ref_mesh((2, 2), ("data", "model")), {"data": 2, "model": 2}
    psh = shd.param_shardings(get_config("smollm-360m"), pm)
    got = shd.opt_state_shardings(psh, {"step": 0}, pm)
    want = ref_shd.opt_state_shardings(
        ref_shd.param_shardings(ref_get_config("smollm-360m"), rm),
        {"step": 0}, rm)
    for part in ("m", "v"):
        assert layers.flatten(got[part]) == _flat_ref(want[part])
    assert got["step"] == tuple(want["step"].spec)


def test_placements_over_a_device_mesh(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert tuple(multi.mesh_dim_names) == ("pod", "data", "model")
    assert tuple(multi.shape) == (2, 16, 16)
    single = make_production_mesh(device="cpu")
    assert tuple(single.shape) == (16, 16)
    assert shd.placements((("pod", "data"), "model"), multi) == \
        (Shard(0), Shard(0), Shard(1))
    assert shd.placements(("model",), single) == (Replicate(), Shard(0))
    assert shd.placements((), single) == (Replicate(), Replicate())
    local = make_local_mesh(device="cpu")
    assert tuple(local.shape) == (1, 1)
    # a shard over one rank is the whole tensor
    assert shd.placements(("data", "model"), local) == \
        (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# the reference's tests/test_sharding.py, mirrored
# ---------------------------------------------------------------------------
def test_spec_drops_nondivisible():
    mesh = {"data": 1, "model": 1}
    rules = {"a": "model", "b": ("pod", "data")}
    assert shd.spec_for((7, 4), ("a", "b"), rules, mesh) == \
        ("model", "data")
    mesh = {"data": 2, "model": 4}
    assert shd.spec_for((7, 4), ("a", "b"), rules, mesh) == (None, "data")
    assert shd.spec_for((8, 3), ("a", "b"), rules, mesh) == ("model",)


def test_param_sharding_tree_matches():
    mesh = {"data": 1, "model": 1}
    for arch in ("smollm-360m", "deepseek-v2-lite-16b", "hymba-1.5b",
                 "seamless-m4t-large-v2"):
        cfg = get_config(arch)
        assert set(layers.flatten(shd.param_shardings(cfg, mesh))) == \
            set(layers.flatten(tf.abstract_params(cfg)))
        ref_leaves = _flat_ref(ref_shd.param_shardings(
            ref_get_config(arch), _ref_mesh((1, 1), ("data", "model"))))
        assert set(layers.flatten(shd.param_shardings(cfg, mesh))) == \
            set(ref_leaves)
        assert len(ref_leaves) == len(jax.tree.leaves(
            ref_abstract_params(ref_get_config(arch))))


def test_head_divisibility_rules():
    """q/kv head sharding only when head count divides TP degree."""
    class FakeMesh:
        shape = {"data": 16, "model": 16}
    rules = shd.logical_rules(get_config("smollm-360m"), FakeMesh())
    assert rules["q_proj"] is None and rules["kv_proj"] is None
    rules = shd.logical_rules(get_config("qwen3-32b"), FakeMesh())
    assert rules["q_proj"] == "model" and rules["kv_proj"] is None
    rules = shd.logical_rules(get_config("deepseek-v2-lite-16b"), FakeMesh())
    assert rules["experts"] == "model"
    rules = shd.logical_rules(get_config("grok-1-314b"), FakeMesh())
    assert rules["experts"] is None and rules["expert_mlp"] == "model"


def test_batch_sharding_nondivisible():
    assert shd.batch_sharding({"data": 1, "model": 1}, (3, 5)) == \
        ("data", None)
    assert shd.batch_sharding({"data": 2, "model": 2}, (3, 5)) == ()


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------
CON_SHAPES = [(256, 4096, 960), (2, 64, 8), (3, 7, 5), (128, 1),
              (32, 16, 4, 2, 64), (16, 256, 2, 8, 32), (512, 32768, 5)]


def _captured(monkeypatch):
    seen = []

    def capture(x, sharding):
        seen.append(tuple(sharding.spec))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    return seen


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("sp", [False, True])
def test_constraint_specs_match_reference(monkeypatch, mesh, sp):
    rm, pm = _ref_mesh(*mesh), _port_mesh(*mesh)
    seen = _captured(monkeypatch)
    with ref_con.activation_mesh(rm, sequence_parallel=sp):
        for shape in CON_SHAPES:
            x = jax.ShapeDtypeStruct(shape, jnp.float32)
            calls = [("residual", lambda: ref_con.constrain_residual(x),
                      lambda: con.residual_spec(shape, pm, sp))]
            for axis in range(len(shape)):
                calls.append(("batch", lambda a=axis:
                              ref_con.constrain_batch(x, a),
                              lambda a=axis: con.batch_spec(shape, a, pm)))
                for name in ("model", "data", "pod"):
                    calls.append(("axis", lambda a=axis, n=name:
                                  ref_con.constrain_axis(x, a, n),
                                  lambda a=axis, n=name:
                                  con.axis_spec(shape, a, n, pm)))
            for what, ref_call, port_spec in calls:
                del seen[:]
                ref_call()
                want = seen[0] if seen else None
                assert port_spec() == want, (what, shape)
    assert con.dp_size(pm) == ref_con.dp_size(rm)


def test_constraints_are_identities_without_a_mesh_or_a_dtensor(fake_world):
    from repro_torch.launch.mesh import make_production_mesh
    x = torch.zeros((32, 16, 8))
    assert con.current_mesh() is None
    for fn in (con.constrain_batch, con.constrain_residual,
               lambda t: con.constrain_axis(t, 1, "model")):
        assert fn(x) is x
    mesh = make_production_mesh(device="cpu")
    with con.activation_mesh(mesh, sequence_parallel=True):
        assert con.current_mesh() is mesh
        for fn in (con.constrain_batch, con.constrain_residual,
                   lambda t: con.constrain_axis(t, 1, "model")):
            assert fn(x) is x                    # plain tensor: identity
    assert con.current_mesh() is None


def test_constraints_redistribute_dtensors(fake_world):
    """On a (2, 2) mesh a DTensor is redistributed to the pinned spec's
    placements; a non-divisible dim is left as it was."""
    from repro_torch.launch.mesh import device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = device_mesh((2, 2), ("data", "model"), "cpu")
    x = distribute_tensor(torch.randn(4, 8, 6), mesh,
                          [Replicate(), Replicate()])
    with con.activation_mesh(mesh, sequence_parallel=True):
        b = con.constrain_batch(x)
        assert tuple(b.placements) == (Shard(0), Replicate())
        r = con.constrain_residual(x)
        assert tuple(r.placements) == (Shard(0), Shard(1))
        a = con.constrain_axis(x, 2, "model")
        assert tuple(a.placements) == (Replicate(), Shard(2))
        odd = distribute_tensor(torch.randn(3, 5), mesh,
                                [Replicate(), Replicate()])
        assert con.constrain_batch(odd) is odd
    # the fake group's collectives move nothing: check shapes, not values
    assert b.to_local().shape == (2, 8, 6)
    assert r.to_local().shape == (2, 4, 6)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m",
                                  "deepseek-v2-lite-16b"])
def test_models_bit_equal_under_activation_mesh(fake_world, arch):
    """loss_fn, its gradient and prefill: the same bits with and without
    ``activation_mesh(make_local_mesh())`` (every hint is the identity
    on a plain tensor): attention, SSD, MoE and the loss chunks pass
    through the hints."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.train_loop import value_and_grad
    cfg = reduced_config(arch)
    g = torch.Generator().manual_seed(3)
    params = tf.init_params(cfg, g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    loss0, g0 = value_and_grad(params, batch, cfg)
    logits0, _ = tf.prefill(params, {"tokens": tokens}, cfg)
    with con.activation_mesh(make_local_mesh(device="cpu")):
        loss1, g1 = value_and_grad(params, batch, cfg)
        logits1, _ = tf.prefill(params, {"tokens": tokens}, cfg)
    assert torch.equal(loss0, loss1) and torch.equal(logits0, logits1)
    for k, v in layers.flatten(g0).items():
        assert torch.equal(v, layers.flatten(g1)[k]), k


def test_dtensor_loss_and_gradient_bit_equal(fake_world):
    """Reduced smollm-360m's loss and gradient with parameters and batch
    as DTensors of the (1, 1) mesh, placed by ``param_shardings``, under
    the hints: the plain tensors' bits."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.train_loop import value_and_grad
    cfg = reduced_config("smollm-360m")
    g = torch.Generator().manual_seed(5)
    params = tf.init_params(cfg, g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    loss0, g0 = value_and_grad(params, batch, cfg)
    mesh = make_local_mesh(device="cpu")
    specs = layers.flatten(shd.param_shardings(cfg, mesh))
    dparams = layers.unflatten({
        k: distribute_tensor(v, mesh, shd.placements(specs[k], mesh))
        for k, v in layers.flatten(params).items()})
    dbatch = {k: distribute_tensor(v, mesh, shd.placements(
        shd.batch_sharding(mesh, tuple(v.shape)), mesh))
        for k, v in batch.items()}
    with implicit_replication(), con.activation_mesh(mesh):
        loss1, g1 = value_and_grad(dparams, dbatch, cfg)
    assert torch.equal(loss0, loss1.full_tensor())
    for k, v in layers.flatten(g0).items():
        assert torch.equal(v, layers.flatten(g1)[k].full_tensor()), k


def test_attention_operators_on_sharded_dtensors(fake_world):
    """The kernels' operators on DTensors of a (2, 2) mesh, sharded on the
    batch or the KV heads: each rank's shard is computed alone (on the
    CPU, by the plain versions) and the output keeps the input's
    placement."""
    from repro_torch.launch.mesh import device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    mesh = device_mesh((2, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((4, 8, 2, 3, 16),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, 8, 2, 16),
                                                 dtype=np.float32))
            for _ in range(2))
    for pl in ([Shard(0), Replicate()], [Replicate(), Shard(2)]):
        dq, dk, dv = (distribute_tensor(x, mesh, pl) for x in (q, k, v))
        out = ops.flash_attention_causal(dq, dk, dv)
        assert tuple(out.placements) == tuple(pl)
        assert out.to_local().shape == dq.to_local().shape
    qd = torch.from_numpy(rng.standard_normal((4, 2, 3, 16),
                                              dtype=np.float32))
    kc = torch.from_numpy(rng.standard_normal((4, 32, 2, 16),
                                              dtype=np.float32))
    kl = torch.tensor([3, 32, 1, 17], dtype=torch.int32)
    out = ops.decode_attention(
        distribute_tensor(qd, mesh, [Shard(0), Replicate()]),
        distribute_tensor(kc, mesh, [Shard(0), Replicate()]),
        distribute_tensor(kc, mesh, [Shard(0), Replicate()]),
        distribute_tensor(kl, mesh, [Shard(0), Replicate()]))
    assert tuple(out.placements) == (Shard(0), Replicate())


def test_time_sharded_cache_write(fake_world):
    """A decode cache sharded on its time axis (the reference's
    sequence-sharded cache) takes the position into the shard that holds
    it and leaves the other shards as they were: this rank (0) holds
    positions 0-3 of 8 over a 2-way ``model`` dim."""
    from repro_torch.launch.mesh import device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import attention
    mesh = device_mesh((2, 2), ("data", "model"), "cpu")
    base = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 1, 3)
    new = -torch.ones((2, 1, 1, 3))
    for start, hit in ((2, True), (6, False), (11, False)):
        cache = distribute_tensor(base.clone(), mesh, [Replicate(), Shard(1)])
        attention._update_at(
            cache, distribute_tensor(new, mesh, [Replicate(), Replicate()]),
            distribute_tensor(torch.tensor(start), mesh,
                              [Replicate(), Replicate()]))
        want = base[:, :4].clone()
        if hit:
            want[:, start] = new[:, 0]
        assert torch.equal(cache.to_local(), want), start
    plain = base.clone()
    attention._update_at(plain, new, torch.tensor(11))   # clamped to T - 1
    assert torch.equal(plain[:, 7], new[:, 0])
