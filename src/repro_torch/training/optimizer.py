"""AdamW (float32 moments over bf16 or float32 parameters) with a
global-norm clip: the port of ``repro.training.optimizer``.

Functions of nested dicts of tensors, as the reference's are of pytrees:
``adamw_update`` returns new parameter and state trees and leaves its
inputs as they are. It runs under ``torch.no_grad``. Arithmetic follows
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


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: gradients clipped to ``cfg.clip_norm`` by their
    global norm, decoupled weight decay on leaves of two or more dims.
    Returns (new params, new state, {"grad_norm": norm})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)       # float32, on the device
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh, vh = m / b1c, v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - cfg.lr * delta).to(p.dtype)
        return new_p, m, v

    out = _map(upd, params, grads, state["m"], state["v"])

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    return (pick(out, 0), {"m": pick(out, 1), "v": pick(out, 2),
                           "step": step}, {"grad_norm": gnorm})
