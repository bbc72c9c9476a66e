"""Model assembly for every architecture family: the port of
``repro.models.transformer``.

- dense / vlm / moe / mla archs: pre-norm residual blocks over a stacked
  layer tree (+ an optional leading unstacked dense layer for DeepSeek's
  ``first_moe_layer=1``), run as a loop over the layers' slices.
- ssm (Mamba-2): pure SSD blocks.
- hybrid (Hymba): parallel attention + SSM heads; layers are unrolled
  (``layer_{i:02d}``) because the per-layer window (SWA against the
  global layers) and the per-layer decode caches differ.
- audio (Seamless): encoder-decoder; a bidirectional encoder stack over
  frame embeddings, the decoder adds cross-attention.
- vlm (LLaVA): a patch-embedding adapter prepended to the text stream.

API (functions of (params, batch), as the reference's; ``decode_step``
writes the cache in place and returns it, where the reference returns a
fresh cache):
  param_defs / init_params / abstract_params / params_from_reference
  opt_state_from_reference                  (AdamW's {"m", "v", "step"})
  loss_fn(params, batch, cfg)               -> scalar, differentiable
  prefill(params, batch, cfg)               -> (last_logits, None)
  init_cache(cfg, batch, max_len, dtype)    -> zero decode cache
  decode_step(params, cache, tokens, cfg)   -> (logits, cache)

Parameters are a nested dict of tensors with the reference's names and
layouts (``params["layers"]["attn"]["wq"]`` is [L, d_model, q_dim]);
norms are float32 and every other weight ``cfg.dtype`` unless its
``ParamDef`` says otherwise. ``init_params`` draws its own weights from a
``torch.Generator`` (JAX's random bits cannot be replayed);
``params_from_reference`` adopts the JAX package's tree as numpy arrays,
checked by name, shape and dtype — the route every parity test takes.

Training: ``loss_fn`` is differentiated by autograd (the flash kernel
through its ``autograd.Function``, whose backward is a kernel too).
``cfg.remat`` picks what a backward pass keeps of each layer, as the
reference's ``_maybe_remat``: ``"none"`` keeps everything; ``"full"``
(the default) keeps each layer's input and recomputes the layer; ``"dots"``
keeps the outputs of the matrix products without batch dims (``aten.mm``)
and recomputes the rest; ``"save_attn"`` keeps the mixer's output (the
reference's ``checkpoint_name(out, "mixer_out")``) by checkpointing the
mixer and the rest of the layer apart. Every policy gives the same
gradient. Each chunk of ``chunked_ce_loss`` is recomputed in the
backward too, as the reference's ``jax.checkpoint`` body is, so the
[B, S, V] logits never exist at once. The stacked layer tree is unbound
once per call (one ``torch.unbind`` a leaf, whose gradient is one
``stack``), not indexed once per layer.

Sharding hints: each decoder layer pins its input with the reference's
``constrain_residual`` and each loss chunk with ``constrain_batch``
(``repro_torch.parallel.constraints``; the identity without an active
mesh or on a plain tensor, so they change no bit).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_DTYPES, ParamDef, Params, flatten,
                                       init_from_defs, rms_norm, unflatten)
from repro_torch.parallel.constraints import (constrain_batch,
                                              constrain_residual,
                                              gather_params, one_axis_batch,
                                              row_gather)

VISION_EMBED_DIM = 1152     # stubbed vision tower output (SigLIP-like)
AUDIO_FEAT_DIM = 160        # stubbed fbank features (80 mel x 2 stacking)
ENC_LEN_AT_DECODE = 4096    # encoder length used by enc-dec decode shapes


# ---------------------------------------------------------------------------
# Param schema
# ---------------------------------------------------------------------------
def _stack(defs: Dict[str, ParamDef], n: int) -> Dict[str, ParamDef]:
    return {k: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init,
                        d.scale_axis + 1, d.dtype) for k, d in defs.items()}


def _norm(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones", dtype="float32")


def _layer_defs(cfg: ModelConfig, moe_layer: bool) -> Dict[str, ParamDef]:
    """Defs for one decoder layer (unstacked)."""
    d = cfg.d_model
    defs: Dict[str, ParamDef] = {}
    if cfg.family == "ssm":
        defs["ssm_norm_in"] = _norm(d)
        for k, v in ssm_mod.ssm_defs(cfg).items():
            defs[f"ssm/{k}"] = v
        return defs
    defs["attn_norm"] = _norm(d)
    amod = attn_mod.mla_defs(cfg) if cfg.attention == "mla" \
        else attn_mod.gqa_defs(cfg)
    for k, v in amod.items():
        defs[f"attn/{k}"] = v
    if cfg.hybrid:
        for k, v in ssm_mod.ssm_defs(cfg).items():
            defs[f"ssm/{k}"] = v
        defs["attn_out_norm"] = _norm(d)
        defs["ssm_out_norm"] = _norm(d)
    if cfg.enc_dec:
        defs["cross_norm"] = _norm(d)
        for k, v in attn_mod.gqa_defs(cfg).items():
            defs[f"cross/{k}"] = v
    defs["ffn_norm"] = _norm(d)
    if moe_layer:
        for k, v in ffn_mod.moe_defs(cfg).items():
            defs[f"moe/{k}"] = v
    else:
        dff = cfg.moe.dense_d_ff if cfg.moe is not None else 0
        for k, v in ffn_mod.dense_defs(cfg, dff).items():
            defs[f"ffn/{k}"] = v
    return defs


def _n_prefix(cfg: ModelConfig) -> int:
    return cfg.moe.first_moe_layer if cfg.moe else 0


def param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Flat {"a/b": ParamDef} schema, as the reference's ``param_defs``."""
    v, d = cfg.padded_vocab, cfg.d_model
    defs: Dict[str, ParamDef] = {
        "embed": ParamDef((v, d), ("vocab", "embed")),
        "final_norm": _norm(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    feat = {"patches": VISION_EMBED_DIM, "frames": AUDIO_FEAT_DIM}
    if cfg.frontend in feat:
        defs["adapter/w"] = ParamDef((feat[cfg.frontend], d),
                                     (None, "embed"))
        defs["adapter/b"] = ParamDef((d,), ("embed",), init="zeros")

    n_prefix = _n_prefix(cfg)
    if cfg.hybrid:
        # unrolled: one subtree per layer (heterogeneous windows/caches)
        for i in range(cfg.num_layers):
            for k, vdef in _layer_defs(cfg, moe_layer=False).items():
                defs[f"layer_{i:02d}/{k}"] = vdef
    else:
        for i in range(n_prefix):
            for k, vdef in _layer_defs(cfg, moe_layer=False).items():
                defs[f"dense_{i}/{k}"] = vdef
        for k, vdef in _stack(
                _layer_defs(cfg, moe_layer=cfg.moe is not None),
                cfg.num_layers - n_prefix).items():
            defs[f"layers/{k}"] = vdef
    if cfg.enc_dec:
        enc_defs: Dict[str, ParamDef] = {"attn_norm": _norm(d),
                                         "ffn_norm": _norm(d)}
        for k, vdef in attn_mod.gqa_defs(cfg).items():
            enc_defs[f"attn/{k}"] = vdef
        for k, vdef in ffn_mod.dense_defs(cfg).items():
            enc_defs[f"ffn/{k}"] = vdef
        for k, vdef in _stack(enc_defs, cfg.encoder_layers).items():
            defs[f"encoder/{k}"] = vdef
        defs["enc_norm"] = _norm(d)
    return defs


def _dtype(d: ParamDef, cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[d.dtype or cfg.dtype]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Fresh parameters on ``device`` (default the card; the generator's
    device), drawn as ``layers.init_from_defs`` draws them."""
    return init_from_defs(param_defs(cfg), generator, _DTYPES[cfg.dtype],
                          resolve_device(device))


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree's shapes and dtypes as tensors on the ``meta``
    device: nothing is allocated."""
    return unflatten({k: torch.empty(d.shape, dtype=_dtype(d, cfg),
                                     device="meta")
                      for k, d in param_defs(cfg).items()})


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                                # a writable copy
    if a.dtype.name == "bfloat16":                 # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(params_np: Dict[str, Any], cfg: ModelConfig,
                          device: DeviceLike = None) -> Params:
    """The JAX package's parameter tree (nested or "a/b"-flat dict of
    numpy arrays) as the port's parameters on ``device`` (default the
    card). Every name, shape and dtype must be the schema's."""
    device = resolve_device(device)
    flat = flatten(params_np) if any(
        isinstance(v, dict) for v in params_np.values()) else dict(params_np)
    defs = param_defs(cfg)
    if set(flat) != set(defs):
        raise ValueError("parameter names differ from the schema: "
                         f"{sorted(set(flat) ^ set(defs))}")
    out = {}
    for name, d in defs.items():
        a = np.asarray(flat[name])
        want = _dtype(d, cfg)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{name}: shape {a.shape} != {d.shape}")
        t = _to_tensor(a, device)
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {a.dtype} != {want}")
        out[name] = t
    return unflatten(out)


def opt_state_from_reference(state_np: Dict[str, Any], cfg: ModelConfig,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's AdamW state ``{"m", "v", "step"}`` (numpy
    arrays: float32 moments in the parameter tree's names and shapes, a
    0-d int32 step) as the port's ``training.optimizer`` state on
    ``device`` (default the card)."""
    device = resolve_device(device)
    defs = param_defs(cfg)
    out = {}
    for part in ("m", "v"):
        tree = state_np[part]
        flat = flatten(tree) if any(isinstance(v, dict)
                                    for v in tree.values()) else dict(tree)
        if set(flat) != set(defs):
            raise ValueError(f"opt state {part}: names differ from the "
                             f"schema: {sorted(set(flat) ^ set(defs))}")
        leaves = {}
        for name, d in defs.items():
            a = np.asarray(flat[name])
            if tuple(a.shape) != tuple(d.shape) or a.dtype != np.float32:
                raise ValueError(f"opt state {part}/{name}: {a.dtype} "
                                 f"{a.shape}, expected float32 {d.shape}")
            leaves[name] = _to_tensor(a, device)
        out[part] = unflatten(leaves)
    step = np.asarray(state_np["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt state step: {step.dtype} {step.shape}")
    out["step"] = _to_tensor(step, device)
    return out


def _take(node, i: int):
    """Slice ``i`` of every leaf of a stacked subtree (views, no copy)."""
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return node[i]


def layer_params(params: Params, i: int, stack: str = "layers") -> Params:
    """Layer ``i``'s slice of the stacked ``params[stack]`` subtree."""
    return _take(params[stack], i)


def _unstack(node, n: int):
    """The ``n`` per-layer trees of a stacked subtree: one ``unbind`` a
    leaf, so autograd joins the layers' gradients with one ``stack``."""
    if isinstance(node, dict):
        parts = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(node))


def _stacked(trees):
    """The trees' leaves stacked on a new leading axis (the reference's
    scan layout)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stacked([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _mixer(p, x, cfg: ModelConfig, *, window: int):
    """Sequence mixer for train / prefill: attention and/or SSM, on the
    layer's input pinned by ``constrain_residual`` (the reference's
    ``_decoder_layer`` pins it first; every decoder layer starts here)."""
    x = constrain_residual(x)
    if cfg.family == "ssm":
        h_in = rms_norm(x, p["ssm_norm_in"], cfg.norm_eps)
        return x + ssm_mod.ssm_fwd(p["ssm"], h_in, cfg)
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.attention == "mla":
        out, _ = attn_mod.mla_fwd(p["attn"], h, cfg)
    else:
        out, _ = attn_mod.gqa_fwd(p["attn"], h, cfg, causal=True,
                                  window=window)
    if cfg.hybrid:
        s_out = ssm_mod.ssm_fwd(p["ssm"], h, cfg)
        out = 0.5 * (rms_norm(out, p["attn_out_norm"], cfg.norm_eps)
                     + rms_norm(s_out, p["ssm_out_norm"], cfg.norm_eps))
    return x + out


def _ffn_block(p, x, cfg: ModelConfig):
    """(x + FFN, aux loss); the aux loss is None for a dense FFN."""
    if cfg.family == "ssm":
        return x, None
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if "moe" in p:
        out, aux = ffn_mod.moe_fwd(p["moe"], h, cfg)
        return x + out, aux
    return x + ffn_mod.dense_fwd(p["ffn"], h, cfg), None


def _layer_tail(p, x, cfg: ModelConfig, enc=None):
    """A decoder layer after its mixer: cross-attention over the encoder
    output ``enc`` (enc-dec; its K and V projected from ``enc`` here, as
    the reference's scan body does), then the FFN. Returns (x, aux)."""
    if cfg.enc_dec and enc is not None:
        shape = (enc.shape[0], enc.shape[1], cfg.num_kv_heads, cfg.head_dim)
        enc_kv = ((enc @ p["cross"]["wk"]).reshape(shape),
                  (enc @ p["cross"]["wv"]).reshape(shape))
        h = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        out, _ = attn_mod.gqa_fwd(p["cross"], h, cfg, kv_override=enc_kv,
                                  rope=False)
        x = x + out
    return _ffn_block(p, x, cfg)


def _decoder_layer(p, x, cfg: ModelConfig):
    """A whole decoder layer without remat (DeepSeek's dense prefix
    layers, as the reference runs them), on its parameters
    FSDP-gathered."""
    p = gather_params(p)
    return _layer_tail(p, _mixer(p, x, cfg, window=0), cfg)


def _layer_window(cfg: ModelConfig, i: int) -> int:
    return 0 if i in cfg.global_attn_layers else cfg.window


# ---------------------------------------------------------------------------
# Rematerialisation (the reference's _maybe_remat)
# ---------------------------------------------------------------------------
def _checkpoint(fn: Callable, *args, **kw):
    """``fn(*args)`` whose activations the backward recomputes (the
    non-reentrant checkpoint; the model draws no random numbers, so no
    RNG state is kept)."""
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


def _keep_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep what a matrix product
    without batch dims computes (``x @ W`` reaches ``aten.mm``; attention
    and the experts' batched products reach ``aten.bmm``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_keep_dots)


def _maybe_remat(mixer: Callable, tail: Callable, cfg: ModelConfig
                 ) -> Callable:
    """The layer body ``tail(p, mixer(p, x), *extra)`` under
    ``cfg.remat`` (see the module doc), each part on its parameters
    FSDP-gathered inside the remat (``constraints.gather_params``: the
    identity without a mesh)."""
    mixer_in, tail_in = mixer, tail

    def mixer(p, x):
        return mixer_in(gather_params(p), x)

    def tail(p, h, *extra):
        return tail_in(gather_params(p), h, *extra)

    def body(p, x, *extra):
        return tail(p, mixer(p, x), *extra)

    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        return lambda p, x, *extra: _checkpoint(body, p, x, *extra)
    if cfg.remat == "dots":
        return lambda p, x, *extra: _checkpoint(body, p, x, *extra,
                                                context_fn=_dots_context)
    if cfg.remat == "save_attn":
        # the mixer's output is the second checkpoint's input, so it is
        # what the backward keeps of the mixer
        return lambda p, x, *extra: _checkpoint(
            tail, p, _checkpoint(mixer, p, x), *extra)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


# ---------------------------------------------------------------------------
# Embedding / loss
# ---------------------------------------------------------------------------
def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion (bf16 @ f32 runs in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _embed_tokens(params, tokens, cfg: ModelConfig):
    return row_gather(gather_params(params["embed"]),
                      one_axis_batch(tokens.long()))


def _frontend_concat(params, batch, cfg: ModelConfig):
    """Returns (x [B,S,D], loss_mask [B,S], labels [B,S])."""
    tokens = batch["tokens"]
    x_txt = _embed_tokens(params, tokens, cfg)
    ones = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if cfg.frontend == "patches":
        ad = gather_params(params["adapter"])
        emb = _mm(batch["patches"], ad["w"])
        emb = emb + ad["b"].to(emb.dtype)
        x = torch.cat([emb.to(x_txt.dtype), x_txt], dim=1)
        labels = batch["labels"]
        pad = torch.zeros(emb.shape[:2], dtype=labels.dtype,
                          device=labels.device)
        mask = torch.cat([torch.zeros(emb.shape[:2], dtype=torch.bool,
                                      device=tokens.device), ones], dim=1)
        return x, mask, torch.cat([pad, labels], dim=1)
    return x_txt, ones, batch["labels"]


def _chunk_nll(xb, lm_head, lb, mb):
    """Summed negative log-likelihood of one chunk's unmasked positions;
    float32 logits and logsumexp."""
    logits = (constrain_batch(xb) @ lm_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    # lse - gold on the gather's own [.., 1] shape: a vocab-sharded
    # DTensor's gathered values stay partial until this subtraction,
    # which torch's DTensor cannot reduce after a reshape
    nll = (lse[..., None] - logits.gather(-1, lb[..., None].long()))[..., 0]
    return torch.where(mb, nll, 0.0).sum()


def chunked_ce_loss(x, lm_head, labels, mask, chunk: int = 1024):
    """Cross-entropy in sequence chunks, each recomputed in the backward
    (the reference's ``jax.checkpoint`` body), so the [B, S, V] logits are
    never alive at once (V can be 256k); float32 logsumexp. As the
    reference, positions past the last whole chunk (nc * (S // nc)) are
    not counted."""
    b, s, d = x.shape
    nc = max(1, s // chunk)
    chunk = s // nc
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + _checkpoint(_chunk_nll, x[:, sl], lm_head, labels[:, sl],
                                mask[:, sl])
        cnt = cnt + mask[:, sl].sum()
    return tot / cnt.clamp(min=1)


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return gather_params(params["embed"].T if cfg.tie_embeddings
                         else params["lm_head"])


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _encoder_mixer(p, x, cfg: ModelConfig):
    hh = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    out, _ = attn_mod.gqa_fwd(p["attn"], hh, cfg, causal=False)
    return x + out


def _encoder_tail(p, x, cfg: ModelConfig):
    return x + ffn_mod.dense_fwd(
        p["ffn"], rms_norm(x, p["ffn_norm"], cfg.norm_eps), cfg)


def _run_encoder(params, frames, cfg: ModelConfig):
    ad = gather_params(params["adapter"])
    x = _mm(frames, ad["w"])
    x = (x + ad["b"].to(x.dtype)).to(_DTYPES[cfg.dtype])
    body = _maybe_remat(lambda p, h: _encoder_mixer(p, h, cfg),
                        lambda p, h: _encoder_tail(p, h, cfg), cfg)
    for lp in _unstack(params["encoder"], cfg.encoder_layers):
        x = body(lp, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _backbone(params, x, cfg: ModelConfig, enc=None):
    """Run the decoder stack on x [B,S,D]: the prefix layers as they are,
    every other layer under ``_maybe_remat``, as the reference. Returns
    (x, aux loss): the prefix layers' aux losses, then the sum over the
    stack's."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def tail(p, h, *extra):
        return _layer_tail(p, h, cfg, *extra)

    if cfg.hybrid:
        for i in range(cfg.num_layers):
            w = _layer_window(cfg, i)
            x, _ = _maybe_remat(
                lambda p, h, w=w: _mixer(p, h, cfg, window=w), tail,
                cfg)(params[f"layer_{i:02d}"], x)
        return x, aux_total
    for i in range(_n_prefix(cfg)):
        x, aux = _decoder_layer(params[f"dense_{i}"], x, cfg)
        if aux is not None:
            aux_total = aux_total + aux
    body = _maybe_remat(lambda p, h: _mixer(p, h, cfg, window=0), tail, cfg)
    extra = (enc,) if cfg.enc_dec else ()
    auxs = []
    n = cfg.num_layers - _n_prefix(cfg)
    for lp in _unstack(params["layers"], n):
        x, aux = body(lp, x, *extra)
        if aux is not None:
            auxs.append(aux)
    if auxs:
        aux_total = aux_total + torch.stack(auxs).sum()
    return x, aux_total


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """The training objective's value (forward only): chunked
    cross-entropy + 0.01 x the MoE aux loss."""
    if cfg.enc_dec:
        enc = _run_encoder(params, batch["frames"], cfg)
        x = _embed_tokens(params, batch["tokens"], cfg)
        mask = torch.ones(batch["tokens"].shape, dtype=torch.bool,
                          device=x.device)
        labels = batch["labels"]
        x, aux = _backbone(params, x, cfg, enc=enc)
    else:
        x, mask, labels = _frontend_concat(params, batch, cfg)
        x, aux = _backbone(params, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    ce = chunked_ce_loss(x, _head(params, cfg), labels, mask)
    return ce + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device: DeviceLike = None
               ) -> Dict[str, Any]:
    """The decode cache, zeros, on ``device`` (default the card): the
    reference's structure (stacked leaves under ``layers``, one subtree a
    layer for hybrid, ``enc_k`` / ``enc_v`` of ENC_LEN_AT_DECODE frames
    for enc-dec); every ``len`` a 0-d int32 device tensor."""
    device = resolve_device(device)
    n_prefix = _n_prefix(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def one_layer(window: int):
        if cfg.family == "ssm":
            return {"ssm": ssm_mod.ssm_init_cache(cfg, batch, dtype, device)}
        if cfg.attention == "mla":
            m = cfg.mla
            c = {"ckv": zeros(batch, max_len, m.kv_lora_rank),
                 "k_rope": zeros(batch, max_len, m.qk_rope_head_dim),
                 "len": zeros(dt=torch.int32)}
        else:
            t = min(window, max_len) if window else max_len
            c = {"k": zeros(batch, t, cfg.num_kv_heads, cfg.head_dim),
                 "v": zeros(batch, t, cfg.num_kv_heads, cfg.head_dim),
                 "len": zeros(dt=torch.int32)}
        if cfg.hybrid:
            c = {"attn": c,
                 "ssm": ssm_mod.ssm_init_cache(cfg, batch, dtype, device)}
        return c

    cache: Dict[str, Any] = {}
    if cfg.hybrid:
        for i in range(cfg.num_layers):
            cache[f"layer_{i:02d}"] = one_layer(_layer_window(cfg, i))
        return cache
    for i in range(n_prefix):
        cache[f"dense_{i}"] = one_layer(0)
    cache["layers"] = _stacked([one_layer(0)] * (cfg.num_layers - n_prefix))
    if cfg.enc_dec:
        cache["enc_k"] = zeros(cfg.num_layers - n_prefix, batch,
                               ENC_LEN_AT_DECODE, cfg.num_kv_heads,
                               cfg.head_dim)
        cache["enc_v"] = torch.zeros_like(cache["enc_k"])
    return cache


def _layer_decode(p, x, cfg: ModelConfig, cache, *, window: int = 0,
                  enc_kv=None):
    """One layer's decode step; ``cache`` (the layer's subtree, or views
    of its slice of the stacked one) is written in place."""
    if cfg.family == "ssm":
        h = rms_norm(x, p["ssm_norm_in"], cfg.norm_eps)
        out, _ = ssm_mod.ssm_decode(p["ssm"], h, cfg, cache["ssm"])
        return x + out
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    attn_cache = cache["attn"] if cfg.hybrid else cache
    if cfg.attention == "mla":
        out, _ = attn_mod.mla_decode(p["attn"], h, cfg, attn_cache)
    else:
        out, _ = attn_mod.gqa_decode(p["attn"], h, cfg, attn_cache,
                                     window=window)
    if cfg.hybrid:
        s_out, _ = ssm_mod.ssm_decode(p["ssm"], h, cfg, cache["ssm"])
        out = 0.5 * (rms_norm(out, p["attn_out_norm"], cfg.norm_eps)
                     + rms_norm(s_out, p["ssm_out_norm"], cfg.norm_eps))
    x = x + out
    if cfg.enc_dec and enc_kv is not None:
        h = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        x = x + attn_mod.gqa_decode_cross(
            p["cross"], h, cfg, enc_kv, enc_kv[0].shape[1])
    x, _ = _ffn_block(p, x, cfg)
    return x


def decode_step(params, cache, tokens, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B, 1] -> (logits [B, V] float32, cache). Writes the new
    position into ``cache`` in place (a stacked leaf through its
    per-layer views), so a step moves one position of each layer's
    cache, not the whole cache, and returns the same dict. Makes no host
    join: every cache length stays on the device."""
    x = _embed_tokens(params, tokens, cfg)
    if cfg.hybrid:
        for i in range(cfg.num_layers):
            name = f"layer_{i:02d}"
            x = _layer_decode(params[name], x, cfg, cache[name],
                              window=_layer_window(cfg, i))
    else:
        for i in range(_n_prefix(cfg)):
            x = _layer_decode(params[f"dense_{i}"], x, cfg,
                              cache[f"dense_{i}"])
        for i in range(cfg.num_layers - _n_prefix(cfg)):
            enc_kv = None
            if cfg.enc_dec:
                enc_kv = (cache["enc_k"][i], cache["enc_v"][i])
            x = _layer_decode(layer_params(params, i), x, cfg,
                              _take(cache["layers"], i), enc_kv=enc_kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg)).float()
    return logits, cache


def prefill(params, batch, cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """Full-sequence prefill. Returns (last-position logits, None): as in
    the reference, the serving layer re-packs KV caches itself."""
    if cfg.enc_dec:
        enc = _run_encoder(params, batch["frames"], cfg)
        x = _embed_tokens(params, batch["tokens"], cfg)
        x, _ = _backbone(params, x, cfg, enc=enc)
    else:
        x, _, _ = _frontend_concat(
            params, {**batch, "labels": torch.zeros_like(batch["tokens"])},
            cfg)
        x, _ = _backbone(params, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ _head(params, cfg)).float()
    return logits, None
