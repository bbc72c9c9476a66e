"""Mesh construction and the hardware model of the card the port runs
on (the port of ``repro.launch.mesh``).

``make_production_mesh`` and ``make_local_mesh`` are functions (not
module constants), so importing this module touches no distributed
state. Each returns a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's shape and axis names, on the card unless the caller
names the CPU. The mesh takes ranks 0..n-1 of the default process group;
when none is open, a mesh opens torch's fake process group of
``FAKE_WORLD`` ranks (this process is rank 0; collectives move nothing),
which is what the dry run lowers a 256- or 512-card mesh over. A mesh
needs a world at least its size: a caller with a real process group of
one rank (a one-card run) can build the local mesh, not the production
ones. Building a mesh first gives DTensor the rules it lacks for the
port's ops (``register_dtensor_rules``); nothing else registers them.

The hardware model: one NVIDIA H100 SXM (NVIDIA's data sheet and the
Hopper architecture white paper; dense rates, without sparsity, at the
full 700 W power limit). ``chip_smoke.py``'s bounds, the trainer's
share of the bf16 peak (``launch/train.py``) and the roofline
(``launch/roofline.py``) divide by these; NVLink's rate stands where the
reference has one ICI link.
"""
from __future__ import annotations

import numpy as np
from torch.distributed.tensor import Replicate, Shard

from repro_torch.device import DeviceLike, resolve_device

PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s per card
PEAK_FLOPS_FP32 = 67e12         # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12                # HBM3 bytes/s per card
NVLINK_BW = 450e9               # NVLink 4 bytes/s each way per card

#: ranks of the fake process group a mesh opens when none is open: the
#: largest mesh here, (2, 16, 16)
FAKE_WORLD = 512

_RULES = {"registered": False}


def register_dtensor_rules() -> None:
    """Give DTensor a rule for the ops the port runs that it has no
    strategy (nor decomposition) for; once a process, before the first
    mesh.

    The attention kernels' operators (``torch.ops.repro_torch.*``) run on
    the local shards when every tensor is replicated, sharded on the
    batch dim, or sharded on the KV-head dim (the sequence and Dh dims
    stay whole, as a kernel needs them). Where a torch version lacks
    them: ``index_copy`` and ``index_add`` (the decode caches' writes,
    the MoE dispatch) run on shards of any dim but the one they index,
    with the index replicated; ``flip`` on shards of any dim it does not
    flip. A version that has a strategy keeps its own."""
    if _RULES["registered"]:
        return
    import torch
    from torch.distributed.tensor.experimental import register_sharding

    import repro_torch.kernels.ops  # noqa: F401 — defines the operators
    ops = torch.ops.repro_torch
    for op, rule in ((ops.flash_attention_causal.default, _flash_rule),
                     (ops.flash_attention_causal_bwd.default,
                      _flash_bwd_rule),
                     (ops.decode_attention.default, _decode_rule)):
        register_sharding(op)(rule)
    aten = torch.ops.aten
    for op, rule in ((aten.index_copy_.default, _index_rule),
                     (aten.index_copy.default, _index_rule),
                     (aten.index_add_.default, _index_rule),
                     (aten.index_add.default, _index_rule),
                     (aten.flip.default, _flip_rule)):
        if not _registered(op):
            register_sharding(op)(rule)
    _RULES["registered"] = True


def _flash_rule(q, k, v):
    # q [B, S, KvH, G, Dh], k and v [B, S, KvH, Dh]
    return [([Replicate()], [Replicate()] * 3),
            ([Shard(0)], [Shard(0)] * 3),
            ([Shard(2)], [Shard(2)] * 3)]


def _flash_bwd_rule(q, k, v, out, dout):
    # (dq, dk, dv) shard as (q, k, v); out and dout as q
    rules = [([Replicate()] * 3, [Replicate()] * 5)]
    for d in (0, 2):
        rules.append(([Shard(d)] * 3, [Shard(d)] * 5))
    return rules


def _decode_rule(q, k, v, kv_len):
    # q [B, KvH, G, Dh], k and v [B, T, KvH, Dh], kv_len [B]
    return [([Replicate()], [Replicate()] * 4),
            ([Shard(0)], [Shard(0)] * 4),
            ([Shard(1)], [Shard(1), Shard(2), Shard(2), Replicate()])]


def _registered(op) -> bool:
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, name, {}) for name in (
        "op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"))


def _index_rule(self, dim, index, source, *rest):
    """(self, dim, index, source[, alpha]): the output as self; shards of
    any dim but ``dim``, the index whole."""
    tail = [None] * len(rest)
    rules = [([Replicate()], [Replicate(), None, Replicate(), Replicate()]
              + tail)]
    for d in range(self.ndim):
        if d != dim % self.ndim:
            rules.append(([Shard(d)], [Shard(d), None, Replicate(),
                                       Shard(d)] + tail))
    return rules


def _flip_rule(self, dims):
    flipped = {d % self.ndim for d in dims}
    return [([Replicate()], [Replicate(), None])] + [
        ([Shard(d)], [Shard(d), None]) for d in range(self.ndim)
        if d not in flipped]


def device_mesh(shape, axes, device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over ranks 0..n-1 with ``axes`` as
    its dim names (see the module doc), DTensor's rules registered."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    register_dtensor_rules()
    dev = resolve_device(device)
    n = int(np.prod(shape))
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=0, world_size=FAKE_WORLD,
                                store=FakeStore())
    if dist.get_world_size() < n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes, device)


def make_local_mesh(device: DeviceLike = None):
    """1-device mesh with the same axis names (tests / smoke runs)."""
    return device_mesh((1, 1), ("data", "model"), device)
