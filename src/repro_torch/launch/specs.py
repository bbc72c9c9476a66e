"""Abstract input specs + step functions for every (architecture x
input-shape) cell (the port of ``repro.launch.specs``).

Shapes (the reference's):
    train_4k     seq_len=4096    global_batch=256   -> train_step
    prefill_32k  seq_len=32768   global_batch=32    -> prefill
    decode_32k   seq_len=32768   global_batch=128   -> serve_step (1 token)
    long_500k    seq_len=524288  global_batch=1     -> serve_step (1 token)

``long_500k`` requires sub-quadratic attention: it runs only for the
ssm/hybrid archs (mamba2-370m, hymba-1.5b); pure full-attention archs skip
it.

Where the reference builds ``jax.ShapeDtypeStruct``s with a
``NamedSharding``, the port builds abstract tensors that allocate
nothing: a ``FakeTensor`` of the global shape (no mesh), or a ``DTensor``
whose local shard is a ``FakeTensor`` of rank 0's shard shape, placed by
``parallel.sharding``'s spec. Every one belongs to the ``FakeTensorMode``
the caller passes, and the step functions run under that mode (the dry
run: ``launch.dryrun.run_cell``). The device is the card unless the
caller names the CPU; on a fake ``cuda`` tensor the attention routes to
the kernels' operators, whose fake implementations give shapes only.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import AUDIO_FEAT_DIM, VISION_EMBED_DIM
from repro_torch.parallel import sharding as shd
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import value_and_grad

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

LONG_OK_FAMILIES = ("ssm", "hybrid")


def cell_supported(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, ("full-attention arch: 524k-token decode is "
                       "quadratic-cost; skipped")
    return True, ""


def abstract(shape, dtype: torch.dtype, spec, mesh, device: torch.device,
             fake_mode):
    """An abstract tensor: a fake one of ``shape`` without a mesh, else a
    DTensor over a fake local shard placed by ``spec``."""
    shape = tuple(shape)
    if mesh is None:
        with fake_mode:
            return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = shd.placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    with fake_mode:
        shard = torch.empty(tuple(local), dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(shard, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _bsh(mesh, shape):
    return shd.batch_sharding(mesh, shape) if mesh is not None else ()


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------
def train_batch_specs(cfg: ModelConfig, mesh, seq: int, batch: int,
                      device, fake_mode) -> Dict[str, Any]:
    def sds(shape, dtype):
        return abstract(shape, dtype, _bsh(mesh, shape), mesh, device,
                        fake_mode)

    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.frontend == "patches":
        n_txt = seq - cfg.num_patches
        return {"tokens": sds((batch, n_txt), i32),
                "labels": sds((batch, n_txt), i32),
                "patches": sds((batch, cfg.num_patches, VISION_EMBED_DIM),
                               bf16)}
    out = {"tokens": sds((batch, seq), i32), "labels": sds((batch, seq), i32)}
    if cfg.enc_dec:
        out["frames"] = sds((batch, seq, AUDIO_FEAT_DIM), bf16)
    return out


def prefill_batch_specs(cfg: ModelConfig, mesh, seq: int, batch: int,
                        device, fake_mode) -> Dict[str, Any]:
    def sds(shape, dtype):
        return abstract(shape, dtype, _bsh(mesh, shape), mesh, device,
                        fake_mode)

    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.frontend == "patches":
        n_txt = seq - cfg.num_patches
        return {"tokens": sds((batch, n_txt), i32),
                "patches": sds((batch, cfg.num_patches, VISION_EMBED_DIM),
                               bf16)}
    if cfg.enc_dec:
        return {"frames": sds((batch, seq, AUDIO_FEAT_DIM), bf16),
                "tokens": sds((batch, 1024), i32)}
    return {"tokens": sds((batch, seq), i32)}


def cache_specs(cfg: ModelConfig, mesh, seq: int, batch: int, device,
                fake_mode) -> Dict[str, Any]:
    with fake_mode:
        cache = tf.init_cache(cfg, batch, seq, torch.bfloat16, device)
    specs = shd.cache_shardings(cfg, mesh, cache) if mesh is not None \
        else None

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, None if spec is None else spec[k])
                    for k, v in node.items()}
        return abstract(node.shape, node.dtype, spec, mesh, device,
                        fake_mode)

    return walk(cache, specs)


def abstract_params_sharded(cfg: ModelConfig, mesh, mode: str = "train",
                            device=None, fake_mode=None):
    sh = layers.flatten(shd.param_shardings(cfg, mesh, mode)) \
        if mesh is not None else {}
    return layers.unflatten({
        k: abstract(d.shape, tf._dtype(d, cfg), sh.get(k), mesh, device,
                    fake_mode)
        for k, d in tf.param_defs(cfg).items()})


def abstract_opt_sharded(cfg: ModelConfig, mesh, abstract_p, device=None,
                         fake_mode=None):
    sh = layers.flatten(shd.param_shardings(cfg, mesh)) \
        if mesh is not None else {}

    def moments():
        return layers.unflatten({
            k: abstract(p.shape, torch.float32, sh.get(k), mesh, device,
                        fake_mode)
            for k, p in layers.flatten(abstract_p).items()})

    return {"m": moments(), "v": moments(),
            "step": abstract((), torch.int32, (), mesh, device, fake_mode)}


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig) -> Callable:
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch, cfg)
        new_p, new_opt, metrics = opt.adamw_update(params, grads, opt_state)
        return new_p, new_opt, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        logits, _ = tf.prefill(params, batch, cfg)
        return logits
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, tokens):
        return tf.decode_step(params, cache, tokens, cfg)
    return serve_step


def build_cell(arch: str, shape_name: str, mesh, *,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[Dict[str, Any]] = None,
               device: DeviceLike = None, fake_mode=None):
    """Returns (step_fn, abstract_args tuple, cfg) for one dry-run cell:
    ``step_fn(*args)`` runs under ``fake_mode`` (a ``FakeTensorMode``;
    one is made if None — read it back from the args' shards). ``cfg``
    and ``shape`` ({seq, batch, kind}) replace the architecture's
    config and ``SHAPES[shape_name]`` (reduced cells in tests); ``mesh``
    None gives unsharded fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg if cfg is not None else get_config(arch)
    info = shape if shape is not None else SHAPES[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    dev = resolve_device(device)
    fake_mode = fake_mode if fake_mode is not None else FakeTensorMode()
    params = abstract_params_sharded(
        cfg, mesh, "train" if kind == "train" else "serve", dev, fake_mode)
    if kind == "train":
        opt_state = abstract_opt_sharded(cfg, mesh, params, dev, fake_mode)
        bspec = train_batch_specs(cfg, mesh, seq, batch, dev, fake_mode)
        return make_train_step(cfg), (params, opt_state, bspec), cfg
    if kind == "prefill":
        bspec = prefill_batch_specs(cfg, mesh, seq, batch, dev, fake_mode)
        return make_prefill_step(cfg), (params, bspec), cfg
    cache = cache_specs(cfg, mesh, seq, batch, dev, fake_mode)
    tokens = abstract((batch, 1), torch.int32, _bsh(mesh, (batch, 1)), mesh,
                      dev, fake_mode)
    return make_serve_step(cfg), (params, cache, tokens), cfg
