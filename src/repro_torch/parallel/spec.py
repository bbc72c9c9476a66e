"""The spec form the parallelism plan shares (``sharding`` computes specs,
``constraints`` pins them), apart from the rules so that the models can
import the constraints without importing themselves.

A spec is what the reference's ``PartitionSpec`` holds: a tuple with one
entry per leading dim — ``None``, a mesh axis name, or a tuple of names,
a one-name tuple held as the bare name, as ``P(*entries)`` holds it.
``placements(spec, mesh)`` turns one into DTensor placements over a
``DeviceMesh``; ``mesh_shape`` reads a mesh's ``{axis name: size}``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

Spec = Tuple[Any, ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a mapping (or an
    object with a ``shape`` mapping, as the reference's tests' fakes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = getattr(mesh, "shape", mesh)
    return dict(shape)


def as_spec(entries) -> Spec:
    """``tuple(P(*entries))``: a one-name tuple entry becomes the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` over a ``DeviceMesh``: ``Shard(d)``
    on each mesh dim that dim ``d``'s entry names (a tuple entry shards
    one dim over several mesh dims, outermost first, as the reference's
    ``P(("pod", "data"))``), ``Replicate()`` on every other mesh dim and
    on a mesh dim of size 1 (a shard over one rank is the whole tensor;
    so the (1, 1) mesh holds every tensor whole)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(axis)
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)
