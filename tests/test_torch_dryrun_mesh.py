"""The grouped-query split under a production mesh, and the dry run's
argument bytes against the JAX package's sharding specs, on the CPU.

Where ``model`` divides the query heads but not the KV heads (16 cards
against mistral-nemo's, qwen3's, nemotron's, llava's and grok's 8 KV
heads), the query projection's heads shard over ``model`` and the
attention's split of H into (KvH, G) cannot be a DTensor view;
``layers.split_groups`` gathers the heads first and ``merge_groups``
brings the gradient back before the reverse split.

- Reduced mistral-nemo-12b widened to 32 query / 8 KV heads (Dh 16,
  d_model 128, batch 32) on a fake (16, 16) world: the dry run's
  train, prefill and decode cells are ``ok`` and each one's
  ``memory.argument_bytes`` equals rank 0's bytes reckoned from the
  reference's specs (``repro.launch.specs`` over an ``AbstractMesh``).
  The (2, 16, 16) cells pass too but cost 35-85 s of a CPU together
  (DTensor's planning on a 3-dim mesh), so they are left to the card's
  sweep (``benchmarks_torch/dryrun_sweep.py``).
- ``launch.specs.argument_bytes`` (the port's reckoning) equals the same
  reckoning from the reference's specs for every supported (arch, shape,
  production mesh) cell at published widths: arithmetic only.
- ``split_groups`` on a plain tensor is a view (same storage, same
  bits), and on a DTensor replicates the H dim only over mesh dims that
  do not divide KvH; the blockwise code's ``heads_whole`` and sequence
  parallelism's ``gather_sequence`` / ``scatter_sequence`` place as
  torch 2.11's DTensor needs.
- Phase 18's GQA-split case (``chip_smoke.gqa_split_config``: 6 / 3
  heads, float32) on a (1, 2) gloo mesh of two processes: loss and
  gradient within 1e-5 of the unsharded port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import _torch_elastic as worlds
import chip_smoke as cs
from benchmarks_torch.common import spawn_ranks
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced
from repro.launch import specs as ref_specs
from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.launch import dryrun, specs
from repro_torch.models import layers
from repro_torch.models.transformer import init_params
from repro_torch.parallel import sharding as shd
from repro_torch.training.train_loop import value_and_grad

ARCH = "mistral-nemo-12b"
WIDE = dict(num_heads=32, num_kv_heads=8, head_dim=16, d_model=128)
BATCH = 32
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [("train_4k", "single"), ("prefill_32k", "single"),
         ("decode_32k", "single")]
TOL = 1e-5


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


def _leaf_bytes(leaf, sizes) -> int:
    """Rank 0's bytes of a reference ``ShapeDtypeStruct`` by its
    sharding's spec: each dim split over its mesh axes, first chunk."""
    local = list(leaf.shape)
    spec = tuple(leaf.sharding.spec) if leaf.sharding is not None else ()
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                local[d] = -(-local[d] // sizes[axis])
    return int(np.prod(local, dtype=np.int64)) * np.dtype(leaf.dtype).itemsize


def ref_argument_bytes(rcfg, shape_name: str, mesh, info=None) -> int:
    """The reference's cell arguments (``repro.launch.specs``' abstract
    inputs over an ``AbstractMesh``), rank 0's bytes."""
    rm = AbstractMesh(*mesh)
    sizes = dict(zip(mesh[1], mesh[0]))
    info = info or ref_specs.SHAPES[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    params = ref_specs.abstract_params_sharded(
        rcfg, rm, mode="train" if kind == "train" else "serve")
    if kind == "train":
        args = (params, ref_specs.abstract_opt_sharded(rcfg, rm, params),
                ref_specs.train_batch_specs(rcfg, rm, seq, batch))
    elif kind == "prefill":
        args = (params, ref_specs.prefill_batch_specs(rcfg, rm, seq, batch))
    else:
        from repro.parallel import sharding as ref_shd
        tokens = jax.ShapeDtypeStruct(
            (batch, 1), jnp.int32,
            sharding=ref_shd.batch_sharding(rm, (batch, 1)))
        args = (params, ref_specs.cache_specs(rcfg, rm, seq, batch), tokens)
    return sum(_leaf_bytes(x, sizes) for x in jax.tree.leaves(args))


def _wide(cfg):
    return dataclasses.replace(cfg, **WIDE)


@pytest.mark.parametrize("shape,mesh", CELLS)
def test_gqa_split_dryrun_cell(fake_world, shape, mesh):
    """The widened reduced GQA config's cell on a production mesh is
    ``ok`` (without the heads' gather the split raises in ``aten.view``:
    an 8-way KV split of heads sharded 16 ways), with the reference's
    argument bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = _wide(reduced_config(ARCH))
    info = dict(dryrun.REDUCED_SHAPES[shape], batch=BATCH)
    assert cfg.num_heads % 16 == 0 and cfg.num_kv_heads % 16
    fake = FakeTensorMode()
    m = dryrun.make_mesh(mesh, "cpu")
    fn, args, _ = specs.build_cell(ARCH, shape, m, cfg=cfg, shape=info,
                                   device="cpu", fake_mode=fake)
    rec = dryrun.measure(fn, args, fake, m)
    mem = rec["memory"]
    want = ref_argument_bytes(_wide(ref_reduced(ARCH)), shape,
                              MESHES[mesh], info)
    assert mem["argument_bytes"] == want
    assert mem["argument_bytes"] == specs.argument_bytes(
        cfg, shape, m, info)["total"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"]
    assert rec["meta_runs_excluded"] is True
    assert rec["jaxpr"]["dot_flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_argument_bytes_match_reference_specs(arch):
    """Every supported (shape, production mesh) cell at published widths:
    the port's reckoning from its specs equals the reference's."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    n = 0
    for shape in specs.SHAPES:
        if not specs.cell_supported(cfg, shape)[0]:
            continue
        for mesh in MESHES.values():
            got = specs.argument_bytes(cfg, shape,
                                       dict(zip(mesh[1], mesh[0])))
            assert got["total"] == ref_argument_bytes(rcfg, shape, mesh), \
                (arch, shape, mesh)
            n += 1
    assert n == (8 if cfg.family in specs.LONG_OK_FAMILIES else 6)


def test_split_groups_plain_is_a_view():
    x = torch.randn(2, 3, 12, 5)
    y = layers.split_groups(x, 4)
    assert y.shape == (2, 3, 4, 3, 5)
    assert y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert y._base is x and torch.equal(y.reshape(x.shape), x)
    z = layers.merge_groups(y, 2, 3, 12, 5)
    assert z.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert torch.equal(z, x)


@pytest.mark.parametrize("kvh,kept", [(8, False), (16, True)])
def test_split_groups_dtensor_placements(fake_world, kvh, kept):
    """H = 32 sharded over ``model`` = 16 (batch over ``data``): 16 KV
    heads keep the sharding on the KV dim, 8 are gathered first."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    m = dryrun.make_mesh("single", "cpu")
    with FakeTensorMode():
        q = _fake_dtensor(m, (32, 4, 32, 16), [Shard(0), Shard(2)])
        out = layers.split_groups(q, kvh)
    assert out.shape == (32, 4, kvh, 32 // kvh, 16)
    want = [Shard(0), Shard(2) if kept else Replicate()]
    assert list(out.placements) == want


def test_gqa_split_step_on_gloo_ranks():
    """Phase 18's GQA-split case on a (1, 2) gloo mesh: 6 query heads
    shard over ``model`` = 2 and 3 KV heads do not; loss and gradient
    equal the unsharded port within 1e-5."""
    cfg = cs.gqa_split_config()
    pm = {"data": 1, "model": 2}
    psh = shd.param_shardings(cfg, pm)["layers"]["attn"]
    assert "model" in psh["wq"] and "model" not in psh["wk"]
    params = init_params(cfg, torch.Generator().manual_seed(18), "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    loss0, g0 = value_and_grad(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    flat = {k: v.detach().numpy() for k, v in layers.flatten(params).items()}
    out = spawn_ranks(functools.partial(
        worlds.sharded_loss_and_grads, cfg=cfg, params=flat, batch=batch),
        2, "cpu", mesh=((1, 2), ("data", "model")))
    for loss, grads in out:
        assert abs(loss - float(loss0)) <= TOL * abs(float(loss0))
        for k, w in layers.flatten(g0).items():
            w = w.numpy()
            err = np.abs(grads[k] - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= TOL, (k, err)


def _fake_dtensor(mesh, shape, placements):
    """A DTensor of ``shape`` over a fake local shard (under the caller's
    fake mode), each sharded dim split over its mesh dim."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for n, p in zip(tuple(mesh.shape), placements):
        if p.is_shard():
            local[p.dim] //= n
    return DTensor.from_local(torch.empty(local), mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def test_blockwise_heads_and_sequence_gathers(fake_world):
    """torch 2.11's DTensor flattens [B, S] or [B, KvH] for a product only
    while the second dim is whole: ``heads_whole`` gathers a sharded
    heads dim (a plain tensor passes as it is), ``gather_sequence``
    gathers the sequence and ``scatter_sequence`` pins a block's output
    back to the residual stream's sharding, both only with sequence
    parallelism on."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import constraints as con
    m = dryrun.make_mesh("single", "cpu")
    plain = torch.zeros(2, 4, 16, 8)
    assert layers.heads_whole(plain) is plain
    with FakeTensorMode():
        kv = _fake_dtensor(m, (32, 64, 16, 8), [Shard(0), Shard(2)])
        assert list(layers.heads_whole(kv).placements) == [Shard(0),
                                                            Replicate()]
        x = _fake_dtensor(m, (32, 64, 128), [Shard(0), Shard(1)])
        assert con.gather_sequence(x) is x            # no mesh hints
        with con.activation_mesh(m):                  # SP off
            assert con.gather_sequence(x) is x
            y = _fake_dtensor(m, (32, 64, 128), [Shard(0), Replicate()])
            assert con.scatter_sequence(y) is y
        with con.activation_mesh(m, sequence_parallel=True):
            assert list(con.gather_sequence(x).placements) == [
                Shard(0), Replicate()]
            assert list(con.scatter_sequence(y).placements) == [
                Shard(0), Shard(1)]
