"""Sharding rules: logical axes -> mesh axes, with divisibility fallbacks
(the port of ``repro.parallel.sharding``, same rules, names and results).

Parallelism plan over the production mesh (pod, data, model):
  - FSDP  : parameter + optimizer-state ``embed`` fan axes sharded over
            (pod, data).
  - TP    : head/mlp/vocab axes over ``model``. Head axes are sharded only
            when the *head count* divides the TP degree (sharding a packed
            H*Dh axis across head boundaries would force a resharding at the
            [B,S,H,Dh] reshape).
  - EP    : MoE expert axis over ``model`` when num_experts divides it
            (DeepSeek 64/16); otherwise expert-internal d_ff TP (Grok 8e).
  - DP    : activations batch axis over (pod, data).
  - Cache : KV-cache time axis over ``model`` when kv-head sharding is not
            divisible (sequence-sharded decode with partial softmax), else
            kv-head sharding.

Every rule degrades to replication when the concrete dim is not divisible.

A spec is what the reference's ``PartitionSpec`` holds: a tuple with one
entry per leading dim — ``None``, a mesh axis name, or a tuple of names,
a one-name tuple held as the bare name, as ``P(*entries)`` holds it —
and, where the reference pops trailing ``None`` entries, without them.
Where the reference returns a ``NamedSharding`` the port returns the
bare spec; ``placements(spec, mesh)`` (``parallel.spec``) turns one into DTensor placements
over a ``DeviceMesh`` (anything with ``mesh_dim_names`` and ``shape``
works for the rules: a ``DeviceMesh`` or a ``{name: size}`` mapping).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import unflatten
from repro_torch.models.transformer import param_defs
from repro_torch.parallel.spec import (  # noqa: F401
    Spec, as_spec, mesh_shape, placements)

FSDP_AXES = ("pod", "data")


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([_axis_size(mesh, a) for a in axis]))
    shape = mesh_shape(mesh)
    return shape[axis] if axis in shape else 1


def _present(mesh, axis):
    """Strip mesh axes that don't exist on this mesh (e.g. 'pod' on a
    single pod)."""
    if axis is None:
        return None
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in shape)
        return kept if kept else None
    return axis if axis in shape else None


def logical_rules(cfg: ModelConfig, mesh, mode: str = "train"
                  ) -> Dict[str, Any]:
    """mode='train': FSDP over (pod, data) + TP over model.
    mode='serve': weights replicated over the DP axes, TP only — a decode
    step has no optimizer state and tiny activations; FSDP would force a
    per-layer weight all-gather on every token."""
    tp = _axis_size(mesh, "model")
    rules: Dict[str, Any] = {
        "vocab": "model",
        "embed": FSDP_AXES if mode == "train" else None,
        "mlp": "model",
        "q_proj": "model" if cfg.num_heads and cfg.num_heads % tp == 0
        else None,
        "kv_proj": "model" if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0
        else None,
        "kv_lora": None,
        "layers": None,
        "ssm_inner": None,
        "ssm_heads": None,
        "batch": FSDP_AXES,
    }
    if cfg.moe is not None:
        if cfg.moe.num_experts % tp == 0:
            rules["experts"] = "model"      # EP
            rules["expert_mlp"] = None
        else:
            rules["experts"] = None         # expert-internal TP
            rules["expert_mlp"] = "model"
    return rules


def _trim(entries) -> Spec:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return as_spec(entries)


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             rules: Dict[str, Any], mesh) -> Spec:
    """Build a spec, dropping any axis whose dim isn't divisible."""
    entries = []
    used: set = set()
    for dim, ax in zip(shape, axes):
        phys = _present(mesh, rules.get(ax)) if ax else None
        if phys is not None:
            flat = phys if isinstance(phys, tuple) else (phys,)
            if any(a in used for a in flat):
                phys = None
            elif dim % _axis_size(mesh, phys) != 0:
                phys = None
            else:
                used.update(flat)
        entries.append(phys)
    return _trim(entries)


def param_shardings(cfg: ModelConfig, mesh, mode: str = "train"
                    ) -> Dict[str, Any]:
    """Spec tree matching ``transformer.param_defs``' structure."""
    rules = logical_rules(cfg, mesh, mode)
    defs = param_defs(cfg)
    return unflatten({k: spec_for(d.shape, d.axes, rules, mesh)
                      for k, d in defs.items()})


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------
def batch_sharding(mesh, shape: Tuple[int, ...]) -> Spec:
    """Shard the leading (batch) dim over the DP axes when divisible."""
    dp = _present(mesh, FSDP_AXES)
    if dp is None or shape[0] % _axis_size(mesh, dp) != 0:
        return ()
    return as_spec((dp,) + (None,) * (len(shape) - 1))


def _cache_spec(names, shape, mesh, tp: int, dp, dpsz: int) -> Spec:
    """One cache leaf's spec, from the names on its path (the last is the
    leaf's) and its shape."""
    has_model = "model" in mesh_shape(mesh)
    leafname = names[-1] if names else ""
    stacked = leafname in ("k", "v", "ckv", "k_rope", "conv", "state",
                           "enc_k", "enc_v") and len(shape) >= 3 and \
        "layers" in names
    off = 1 if stacked else 0
    ent: list = [None] * len(shape)
    if leafname in ("k", "v", "enc_k", "enc_v") and len(shape) >= 4 + off:
        b, t, kvh = shape[off], shape[off + 1], shape[off + 2]
        if dp is not None and b % dpsz == 0:
            ent[off] = dp
        if kvh % tp == 0 and has_model:
            ent[off + 2] = "model"
        elif t % tp == 0 and has_model:
            ent[off + 1] = "model"
    elif leafname in ("ckv", "k_rope") and len(shape) >= 3 + off:
        b, t = shape[off], shape[off + 1]
        if dp is not None and b % dpsz == 0:
            ent[off] = dp
        if t % tp == 0 and has_model:
            ent[off + 1] = "model"
    elif leafname == "state" and len(shape) >= 4 + off:
        b, nh = shape[off], shape[off + 1]
        if dp is not None and b % dpsz == 0:
            ent[off] = dp
        if nh % tp == 0 and has_model:
            ent[off + 1] = "model"
    elif leafname == "conv" and len(shape) >= 3 + off:
        if dp is not None and shape[off] % dpsz == 0:
            ent[off] = dp
    return _trim(ent)


def cache_shardings(cfg: ModelConfig, mesh, cache) -> Any:
    """Spec tree of the decode cache (``transformer.init_cache``'s tree,
    walked by leaf name, as the reference walks its pytree).

    KV tensors [.., B, T, KvH, Dh]: batch over DP; kv-heads over model when
    divisible, else the time axis over model (sequence-sharded decode).
    SSM state [.., B, nh, hd, ds]: heads over model when divisible.
    """
    tp = _axis_size(mesh, "model")
    dp = _present(mesh, FSDP_AXES)
    dpsz = _axis_size(mesh, dp)

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,)) for k, v in node.items()}
        return _cache_spec(names, tuple(node.shape), mesh, tp, dp, dpsz)

    return walk(cache, ())


def opt_state_shardings(param_sh, extra_scalars: Dict[str, Any], mesh):
    return {"m": param_sh, "v": param_sh,
            **{k: () for k in extra_scalars}}
