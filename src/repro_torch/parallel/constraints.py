"""Activation sharding constraints, threaded via a context variable (the
port of ``repro.parallel.constraints``).

Model code calls ``constrain_batch(x)`` on [B, ...] activations; when a
mesh has been installed (``activation_mesh``: the dry run, a sharded
step), this pins the batch dim to the DP axes. Outside a mesh context,
and on a plain tensor, each function is the identity: it returns ``x``
itself, so it changes no bit and launches nothing. On a ``DTensor``
under an active mesh it ``redistribute``s ``x`` to the spec the
reference's ``with_sharding_constraint`` pins, with the same
divisibility fallbacks (where the reference returns ``x`` unpinned, so
does the port). ``axis_spec``, ``batch_spec`` and ``residual_spec``
return that spec (``None`` where nothing is pinned), in
``parallel.sharding``'s spec form.

``gather_sequence`` and ``scatter_sequence`` (sequence parallelism
only) gather a block's input over the sequence before its products and
pin its output back to the residual stream's sequence sharding, which
XLA does by itself and torch 2.11's DTensor cannot (it refuses to
flatten [B, S] for a product while S is sharded).

``gather_params`` is the port's one FSDP hint the reference has no call
for:
XLA inserts FSDP's per-layer all-gather of the weights by itself, while
DTensor picks each product's sharding by cost and may split a product's
output over ``model`` where the reference keeps it whole (and then
cannot split that dim into heads that do not divide the TP degree). So
each layer's parameters are all-gathered over the FSDP axes (pod,
data) where the layer uses them — inside its remat, so the backward
gathers again, as the reference's scan body does — and their gradients
reduce-scatter back. Identity without a mesh and on plain tensors.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch

from repro_torch.parallel.spec import Spec, as_spec, mesh_shape, placements

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_mesh", default=None)
_SEQ_PARALLEL: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_sequence_parallel", default=False)

DP_AXES = ("pod", "data")


@contextlib.contextmanager
def activation_mesh(mesh, sequence_parallel: bool = False):
    tok = _MESH.set(mesh)
    tok2 = _SEQ_PARALLEL.set(sequence_parallel)
    try:
        yield
    finally:
        _MESH.reset(tok)
        _SEQ_PARALLEL.reset(tok2)


def current_mesh():
    return _MESH.get()


def _dp(mesh):
    shape = mesh_shape(mesh)
    kept = tuple(a for a in DP_AXES if a in shape)
    return kept if kept else None


def dp_size(mesh) -> int:
    dp = _dp(mesh)
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in dp])) if dp else 1


def axis_spec(shape, axis: int, mesh_axis: str, mesh) -> Optional[Spec]:
    """What ``constrain_axis`` pins on ``mesh``, or ``None``."""
    sizes = mesh_shape(mesh) if mesh is not None else {}
    if mesh is None or mesh_axis not in sizes or \
            shape[axis] % sizes[mesh_axis] != 0:
        return None
    spec = [None] * len(shape)
    spec[axis] = mesh_axis
    return as_spec(spec)


def batch_spec(shape, batch_axis: int, mesh) -> Optional[Spec]:
    """What ``constrain_batch`` pins on ``mesh``, or ``None``."""
    if mesh is None:
        return None
    dp = _dp(mesh)
    if dp is None or shape[batch_axis] % dp_size(mesh) != 0:
        return None
    spec = [None] * len(shape)
    spec[batch_axis] = dp
    return as_spec(spec)


def residual_spec(shape, mesh, sequence_parallel: bool) -> Optional[Spec]:
    """What ``constrain_residual`` pins on ``mesh``, or ``None``."""
    if mesh is None or len(shape) < 3:
        return batch_spec(shape, 0, mesh)
    dp = _dp(mesh)
    sizes = mesh_shape(mesh)
    spec = [None] * len(shape)
    if dp is not None and shape[0] % dp_size(mesh) == 0:
        spec[0] = dp
    if sequence_parallel and "model" in sizes and \
            shape[1] % sizes["model"] == 0:
        spec[1] = "model"
    if all(s is None for s in spec):
        return None
    return as_spec(spec)


def _pin(x: torch.Tensor, spec: Optional[Spec], mesh) -> torch.Tensor:
    """``x`` redistributed to ``spec`` over ``mesh`` if it is a DTensor
    and a spec applies; else ``x`` itself."""
    from torch.distributed.tensor import DTensor
    if spec is None or not isinstance(x, DTensor):
        return x
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_axis(x: torch.Tensor, axis: int, mesh_axis: str
                   ) -> torch.Tensor:
    """Pin one dim of x to a named mesh axis (no-op without mesh / axis
    absent / non-divisible)."""
    mesh = _MESH.get()
    return _pin(x, axis_spec(x.shape, axis, mesh_axis, mesh), mesh)


def constrain_batch(x: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """Pin x's batch dim to the DP mesh axes (no-op without mesh /
    non-divisible batch)."""
    mesh = _MESH.get()
    return _pin(x, batch_spec(x.shape, batch_axis, mesh), mesh)


def gather_params(tree):
    """The FSDP all-gather of a parameter (sub)tree: each DTensor leaf
    with its (pod, data) mesh dims replicated and its ``model`` sharding
    kept (see the module doc); the tree itself without an active mesh,
    and a plain leaf as it is."""
    mesh = _MESH.get()
    if mesh is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    names = tuple(mesh.mesh_dim_names)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if not isinstance(x, DTensor):
            return x
        want = tuple(Replicate() if names[i] in DP_AXES else p
                     for i, p in enumerate(x.placements))
        return x if want == tuple(x.placements) else \
            x.redistribute(mesh, want)

    return one(tree)


def one_axis_batch(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its batch dim sharded over one mesh dim at most: a
    DTensor whose dim 0 is sharded over (pod, data) at once keeps the
    innermost of them (torch's DTensor has no ``index`` strategy for
    indices sharded over two mesh dims; the embedding gather's output is
    pinned to the full batch spec right after, by the layer's
    ``constrain_residual``). Anything else is returned as it is."""
    placements = tuple(getattr(x, "placements", ()))
    sharded = [i for i, p in enumerate(placements) if p.is_shard(0)]
    if len(sharded) < 2:
        return x
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if i in sharded[:-1] else p
                 for i, p in enumerate(placements))
    return x.redistribute(x.device_mesh, want)


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; with DTensor indices that are sharded, or whose
    table takes a gradient on a mesh of more than one rank, as
    ``index_select`` (whose gradient is an ``index_add``), because
    torch's DTensor fails to place the gradient of ``index``'s backward
    (``index_put``): with sharded indices, and (torch 2.11) with
    replicated ones when the gradient arrives sharded on the batch, as
    on a (1, 2) mesh. The same rows either way; plain indices, indices
    without a gradient to place, and a one-rank mesh are indexed as they
    are (so a one-card mesh keeps the plain path's gradient bits:
    ``index_add`` sums in another order on the card)."""
    placements = tuple(getattr(idx, "placements", ()))
    if not any(p.is_shard() for p in placements) and not (
            placements and table.requires_grad and torch.is_grad_enabled()
            and idx.device_mesh.size() > 1):
        return table[idx]
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        *idx.shape, table.shape[-1])


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """A sequence-parallel block's input gathered over the sequence: with
    sequence parallelism on, a DTensor [B, S, ...] whose S dim is sharded
    (``constrain_residual``'s pin) is all-gathered on that dim before the
    block's products (Megatron-SP's gather; XLA inserts it by itself),
    and its gradient scatters back. torch 2.11's DTensor cannot flatten
    [B, S] for a product while S is sharded. Identity without sequence
    parallelism, without a mesh and on a plain tensor."""
    placements = tuple(getattr(x, "placements", ()))
    if not _SEQ_PARALLEL.get() or _MESH.get() is None or \
            not any(p.is_shard(1) for p in placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(1) else p for p in placements))


def scatter_sequence(x: torch.Tensor) -> torch.Tensor:
    """A sequence-parallel block's output pinned to the residual stream's
    spec (``constrain_residual``: S over ``model``; Megatron-SP's
    reduce-scatter), so that its gradient, sharded on S like the
    stream's, is brought back to the product's own placements before
    the product's backward flattens [B, S] (see ``gather_sequence``).
    Identity without sequence parallelism."""
    return constrain_residual(x) if _SEQ_PARALLEL.get() else x


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Residual-stream constraint at layer boundaries for [B, S, D]
    activations. Default: batch over DP. With sequence parallelism on
    (Megatron-SP style): additionally shard S over ``model``, so the
    saved remat residuals occupy 1/TP of the memory per device."""
    mesh = _MESH.get()
    return _pin(x, residual_spec(x.shape, mesh, _SEQ_PARALLEL.get()), mesh)
