"""AdamW (float32 moments over bf16 or float32 parameters) with a
global-norm clip: the port of ``repro.training.optimizer``.

Functions of nested dicts of tensors, as the reference's are of pytrees:
``adamw_update`` returns new parameter and state trees and leaves its
inputs as they are (or, donated, writes the new values over them). It
runs under ``torch.no_grad``. Arithmetic follows
the reference's op for op in float32 (the bias corrections as float32
powers of the step), so the same inputs give the same bits up to the
backend's rounding of ``sqrt`` and ``pow``.

The leaves may be ``DTensor``s (a sharded step, under
``implicit_replication``): each moment then takes its parameter's
placements, the step is replicated on their mesh, and ``global_norm``
sums each leaf's squares over its shards (a partial sum, reduced once
over the mesh) before the square root.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (the first's)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def init_opt_state(params) -> Dict[str, Any]:
    """Zero float32 moments beside each parameter (placed as it is, for
    ``DTensor`` parameters) and a 0-d int32 step, on the parameters'
    device (replicated on their mesh)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    first = next(_leaves(params))
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    mesh = getattr(first, "device_mesh", None)
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": step}


def abstract_opt_state(params) -> Dict[str, Any]:
    """``init_opt_state``'s shapes and dtypes on the ``meta`` device."""
    def meta(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"m": _map(meta, params), "v": _map(meta, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    sq = sum(torch.sum(torch.square(g.float())) for g in _leaves(tree))
    return torch.sqrt(sq)


#: elements of a leaf that a donated update takes at once (each float32
#: temporary of a slice is 256 MiB): a 1.6 G-element embedding would
#: otherwise hold several 6.3 GB temporaries at once
DONATE_CHUNK = 1 << 26


def _in_place(upd, p, g, m, v):
    """``upd`` over DONATE_CHUNK-element slices of one leaf, each slice's
    new parameter and moments written over its old ones: the same
    elementwise arithmetic, so the same bits, with no second copy of the
    leaf. Returns the leaf's (parameter, m, v), updated."""
    if getattr(p, "device_mesh", None) is not None:
        raise TypeError("a donated update takes plain tensors")
    if not all(x.is_contiguous() for x in (p, m, v)):
        raise ValueError("a donated update writes contiguous leaves")
    flat = [x.view(-1) for x in (p, m, v)]
    grad = g.reshape(-1)
    for lo in range(0, p.numel(), DONATE_CHUNK):
        part = slice(lo, lo + DONATE_CHUNK)
        new = upd(flat[0][part], grad[part], flat[1][part], flat[2][part],
                  p.dim() >= 2)
        for dst, src in zip(flat, new):
            dst[part].copy_(src)
    return p, m, v


def _on_shards(upd, p, g, m, v):
    """``upd`` of one leaf (its decay by its dims). On a ``DTensor`` leaf
    it runs on the rank's local shards (the gradient first brought to
    the parameter's placements; the moments are placed as the parameter,
    ``init_opt_state``; the 0-d scalars it closes over are replicated)
    and the results are wrapped back in the parameter's placements:
    DTensor runs each elementwise op on the local shards alike, so the
    bits are the same, without planning each op of each leaf."""
    mesh = getattr(p, "device_mesh", None)
    if mesh is None or any(tuple(x.placements) != tuple(p.placements)
                           for x in (m, v)):
        return upd(p, g, m, v, p.dim() >= 2)
    from torch.distributed.tensor import DTensor
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(mesh, p.placements)
    out = upd(p.to_local(), g.to_local(), m.to_local(), v.to_local(),
              p.dim() >= 2)
    return tuple(DTensor.from_local(x, mesh, p.placements, run_check=False,
                                    shape=p.shape, stride=p.stride())
                 for x in out)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig = AdamWConfig(),
                 donate: bool = False
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: gradients clipped to ``cfg.clip_norm`` by their
    global norm, decoupled weight decay on leaves of two or more dims.
    Returns (new params, new state, {"grad_norm": norm}).

    ``donate`` (the reference's jitted step donates its parameters and
    state): the new parameters and moments are written over the old
    ones, a slice of a leaf at a time, so the step never holds a second
    copy of either tree (plain contiguous tensors only); the returned
    trees hold the same tensors. The same bits either way."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)       # float32, on the device
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    if getattr(scale, "device_mesh", None) is not None:
        # replicated 0-d values: each rank's local value is the whole one
        scale, b1c, b2c = (x.full_tensor() for x in (scale, b1c, b2c))

    def upd(p, g, m, v, decay):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh, vh = m / b1c, v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - cfg.lr * delta).to(p.dtype)
        return new_p, m, v

    if donate:
        out = _map(lambda *leaves: _in_place(upd, *leaves), params, grads,
                   state["m"], state["v"])
    else:
        out = _map(lambda p, g, m, v: _on_shards(upd, p, g, m, v),
                   params, grads, state["m"], state["v"])

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    return (pick(out, 0), {"m": pick(out, 1), "v": pick(out, 2),
                           "step": step}, {"grad_norm": gnorm})
