"""The port-side worlds of ``tests/test_torch_elastic.py``: each runs on
every rank of a mesh spawned by ``benchmarks_torch.common.spawn_ranks``
over gloo. They import nothing of the reference; the training worlds
are ``chip_smoke.elastic_world`` (phase 18's, on the CPU) with the
checkpoint and flash checks of the same world beside them, and
``chip_smoke.sharded_world`` (phase 19's) for the sharded families.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

#: specs of the mixed-dtype state (``test_torch_training._state_np``'s
#: tree) on a ("data", "model") mesh: shards over one, both or neither
MIXED_SPECS = {"params": {"w": ("model",), "scale": ("data",)},
               "opt": {"m": {"w": ("data", "model")}, "q": ("model",),
                       "r": (), "step": ()}}


def _bits(tree) -> dict:
    """Each leaf of a state tree (``DTensor``s gathered, a collective) as
    (the numpy array a save writes, its manifest dtype name)."""
    from repro_torch.checkpoint.manager import _to_host
    from repro_torch.models.layers import flatten
    return {k: _to_host(v) for k, v in flatten(tree).items()}


def first_world(mesh, cases, root: str, mixed, port_dir: str):
    """The first world: phase 18's training world, the flash operators
    on this mesh's shards, and a synchronous save of ``mixed`` (a port
    state tree) placed by ``MIXED_SPECS``."""
    import chip_smoke as cs
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.layers import flatten, unflatten
    from repro_torch.parallel.spec import named_shardings
    out = {"elastic": cs.elastic_world(mesh, cases, root, True, "cpu"),
           "flash": cs.flash_on_shards(mesh, "cpu")}
    sh = flatten(named_shardings(mesh, MIXED_SPECS))
    state = unflatten({k: distribute_tensor(v, mesh, sh[k].placements,
                                            src_data_rank=None)
                       for k, v in flatten(mixed).items()})
    CheckpointManager(port_dir, async_save=False).save(
        5, state, extra={"note": "port"})
    out["saved"] = Path(port_dir, "LATEST").exists()
    return out


def second_world(mesh, cases, root: str, ref_dir: str, reshard_dir: str):
    """The restart: phase 18's training world; the reference's
    mixed-dtype checkpoint restored onto ``MIXED_SPECS`` (each leaf's
    type and placements, then its bits gathered); the reference's
    ``test_elastic_reshard_restore`` state with ``w`` sharded by rows
    and ``scale`` left whole on the CPU."""
    import chip_smoke as cs
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.layers import flatten
    from repro_torch.parallel.spec import NamedSharding, named_shardings
    out = {"elastic": cs.elastic_world(mesh, cases, root, False, "cpu")}
    sh = named_shardings(mesh, MIXED_SPECS)
    step, state, extra = CheckpointManager(ref_dir).restore(shardings=sh)
    flat_sh = flatten(sh)
    out["ref_mixed"] = {
        "step": step, "extra": extra,
        "placed": all(isinstance(x, DTensor) and tuple(x.placements)
                      == flat_sh[k].placements
                      for k, x in flatten(state).items()),
        "bits": _bits(state)}
    _, state, _ = CheckpointManager(reshard_dir).restore(
        shardings={"params": {"w": NamedSharding(mesh, ("model",))},
                   "opt": {"m": {"w": NamedSharding(mesh, ())}}},
        device="cpu")
    w = state["params"]["w"]
    out["reshard"] = {
        "w11": float(w.full_tensor()[1, 1].float()),
        "w_local": tuple(w.to_local().shape),
        "scale_type": type(state["params"]["scale"]).__name__,
        "scale": np.asarray(state["params"]["scale"]).tolist(),
        "m_type": type(state["opt"]["m"]["w"]).__name__}
    return out


def to_port(tree):
    """A numpy state tree (ml_dtypes' bf16 / float8 leaves as their
    bits' views) as port tensors on the CPU."""
    def leaf(v):
        name = v.dtype.name
        if name == "bfloat16":
            return torch.from_numpy(np.array(v).view(np.int16)).view(
                torch.bfloat16)
        if name.startswith("float8"):
            return torch.from_numpy(np.array(v).view(np.uint8)).view(
                getattr(torch, name))
        return torch.from_numpy(np.array(v))
    return {k: to_port(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def sharded_loss_and_grads(mesh, cfg, params: dict, batch: dict):
    """One ``value_and_grad`` of ``cfg`` on this rank of ``mesh``: the
    parameters (numpy by leaf name) placed by ``param_shardings``, the
    batch by ``batch_sharding``, under ``activation_mesh`` and
    ``implicit_replication``, as phase 18's step runs. Returns the loss
    and the gradients gathered (numpy by leaf name)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import flatten, unflatten
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.constraints import activation_mesh
    from repro_torch.training.train_loop import value_and_grad
    specs = flatten(shd.param_shardings(cfg, mesh))
    p = unflatten({k: distribute_tensor(
        torch.from_numpy(v), mesh, shd.placements(specs[k], mesh),
        src_data_rank=None) for k, v in params.items()})
    b = {k: distribute_tensor(torch.from_numpy(v), mesh, shd.placements(
        shd.batch_sharding(mesh, v.shape), mesh), src_data_rank=None)
        for k, v in batch.items()}
    with activation_mesh(mesh), implicit_replication():
        loss, grads = value_and_grad(p, b, cfg)
    return float(loss.full_tensor()), {
        k: v.full_tensor().numpy() for k, v in flatten(grads).items()}


def families_world(mesh, cases):
    """``chip_smoke.sharded_world`` (phase 19's world) on this CPU rank,
    one thread a rank: the ranks are bound by DTensor's planning in
    Python, and several worlds run at once."""
    import chip_smoke as cs
    torch.set_num_threads(1)
    return cs.sharded_world(mesh, cases, "cpu")
