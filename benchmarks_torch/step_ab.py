"""The port's main paths timed from one tree, for an A/B of two trees on
one card.

    python3 benchmarks_torch/step_ab.py [--tree DIR] [--parts train,mla_train,models,grad,serve,host]

Imports ``chip_smoke`` and ``repro_torch`` from ``DIR`` (a checkout of
the repo; this one by default), so the same script times a parent
commit unpacked beside the change. Compare two trees only within one
call, in the order parent, change, change, parent. The parts:

* ``train``: ``chip_smoke.py`` phase 15's 20 AdamW steps (smollm-360m,
  full width and depth, bf16, remat "full", B=8 x S=2,048): the median
  step (steps 2-20, host clock around a step that ends in a
  synchronisation) and the step-20 loss;
* ``mla_train``: phase 15's deepseek-v2-lite run (published widths, its
  first 2 of 27 layers, bf16, remat "full", AdamW, B=2 x S=2,048, 5
  steps): the median step (steps 2-5), the step-5 loss, the peak memory
  and the backward's launches by route. It drives ``Trainer`` itself,
  with no save, so that a tree whose ``train_steps`` always saves and
  restores times the same 5 steps;
* ``models``: phase 14's ``model_bf16`` for each configuration (B=2,
  S=512, bf16): the median prefill and decode step;
* ``grad``: one loss and gradient (``value_and_grad``) of hymba-1.5b and
  seamless-m4t-large-v2 at phase 14's width, depth and batch (remat
  "full"), the median of ``GRAD_REPS`` after one warm-up: the paths that
  run the blockwise attention on the card (hymba's windowed layers,
  seamless's encoder and cross-attention);
* ``serve``: the serving path (``drive_serving``, smollm-360m): the
  median of every traced span, the decode step among them;
* ``host``: host microseconds a call, launched back to back on small
  card tensors, of the flash operator's forward (inputs requiring
  grad), its forward and backward, and the decode operator; from them
  the host time of phase 15's 64 forward and 32 backward calls a step
  and of a serving step's decode calls (one a layer); and, where the
  tree has them, each sharding hint of the models without a mesh and
  its calls in one phase-15 loss and gradient.

Prints one JSON line a part, then the card's name and power limit as
``nvidia-smi`` gives them. Needs a GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

GRAD_ARCHS, GRAD_REPS = ("hymba-1.5b", "seamless-m4t-large-v2"), 5
MLA_ARCH, MLA_LAYERS, MLA_STEPS = "deepseek-v2-lite-16b", 2, 5
HOST_REPS = 2000
HINTS = ("constrain_batch", "constrain_residual", "gather_params",
         "one_axis_batch", "row_gather")


def _median_ms(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def part_train(cs):
    r = cs.train_steps("cuda")
    ms = [h["step_time_s"] * 1e3 for h in r["hist"]]
    return {"median_step_ms": statistics.median(ms[1:]),
            "step_ms": [round(x, 3) for x in ms],
            "loss20": r["hist"][-1]["loss"], "peak_gib": r["peak_gib"]}


def part_mla_train(cs):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (PackedBatchIterator,
                                           SyntheticTokenSource)
    from repro_torch.kernels import ops
    from repro_torch.training.train_loop import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS,
                              dtype="bfloat16", remat="full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = PackedBatchIterator(SyntheticTokenSource(cfg.vocab_size, seed=0),
                               batch=2, seq_len=2048)
    trainer = Trainer(cfg, TrainConfig(steps=MLA_STEPS, log_every=1), data,
                      device="cuda")
    trainer.on_log = lambda entry: None
    ops.reset_launches()
    trainer.run(MLA_STEPS)
    data.close()
    ms = [h["step_time_s"] * 1e3 for h in trainer.history]
    routes = {k: v for k, v in ops.LAUNCHES.items()
              if k.startswith("flash_attention_causal_bwd/") and v}
    out = {"median_step_ms": statistics.median(ms[1:]),
           "step_ms": [round(x, 3) for x in ms],
           "loss5": trainer.history[-1]["loss"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "bwd_launches": routes}
    del trainer
    torch.cuda.empty_cache()
    return out


def part_models(cs):
    out = {}
    for name, depth in cs.MODEL_ARCHS:
        r = cs.model_bf16(name, depth, "cuda")
        out[name] = {"prefill_ms": statistics.median(r["prefill_ms"]),
                     "decode_ms": statistics.median(r["decode_ms"]),
                     "loss": r["loss"]}
    return out


def part_grad(cs):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training.train_loop import value_and_grad
    out = {}
    for name in GRAD_ARCHS:
        cfg = get_config(name)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        batch = cs.full_batch(cfg, "cuda")
        loss = value_and_grad(params, batch, cfg)[0]      # warm-up
        out[name] = {"step_ms": _median_ms(
            lambda: value_and_grad(params, batch, cfg), GRAD_REPS),
            "loss": float(loss), "remat": cfg.remat}
        del params, batch
        torch.cuda.empty_cache()
    return out


def part_serve(cs):
    from repro_torch.configs import get_config
    r = cs.drive_serving(get_config(cs.SERVE_ARCH))
    return {"spans_median_ms": {k: statistics.median(v)
                                for k, v in r["spans_ms"].items() if v},
            "steps": r["steps"], "tokens": r["tokens"]}


def _host_us(fn, reps=HOST_REPS):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def part_host(cs):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (1, 128, 1, 3, 64)
    q = torch.randn(shape, generator=g, device="cuda",
                    dtype=torch.bfloat16).requires_grad_(True)
    k, v = (torch.randn((1, 128, 1, 64), generator=g, device="cuda",
                        dtype=torch.bfloat16).requires_grad_(True)
            for _ in range(2))
    dout = torch.randn(shape, generator=g, device="cuda",
                       dtype=torch.bfloat16)

    def fwd_bwd():
        ops.flash_attention_causal(q, k, v).backward(dout)

    # autograd's device thread does device work before the timed calls
    (torch.ones(4, device="cuda", requires_grad=True) * 2).sum().backward()

    fwd = _host_us(lambda: ops.flash_attention_causal(q, k, v))
    both = _host_us(fwd_bwd)
    qd = torch.randn((2, 5, 3, 64), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    kc = torch.randn((2, 256, 5, 64), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    kl = torch.full((2,), 200, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        dec = _host_us(lambda: ops.decode_attention(qd, kc, kc, kl))
    layers_n = get_config(cs.TRAIN_ARCH).num_layers
    out = {"flash_fwd_us": fwd, "flash_fwd_bwd_us": both,
           "decode_us": dec,
           "flash_ms_per_train_step": (64 * fwd + 32 * (both - fwd)) / 1e3,
           "decode_ms_per_serve_step": layers_n * dec / 1e3}
    mods = [m for m in (tf, layers, sys.modules.get("repro_torch.models.ssm"),
                        sys.modules.get("repro_torch.models.ffn"))
            if m is not None]
    present = [h for h in HINTS if any(hasattr(m, h) for m in mods)]
    if not present:
        return out
    calls = dict.fromkeys(present, 0)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    saved = []
    for m in mods:
        for h in present:
            if hasattr(m, h):
                saved.append((m, h, getattr(m, h)))
                setattr(m, h, counted(h, getattr(m, h)))
    from repro_torch.models import init_params
    from repro_torch.training.train_loop import value_and_grad
    cfg = get_config(cs.TRAIN_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (8, 2048), device="cuda",
                           generator=g)
    try:
        value_and_grad(params, {"tokens": tokens, "labels": tokens}, cfg)
        torch.cuda.synchronize()
    finally:
        for m, h, fn in saved:
            setattr(m, h, fn)
    del params
    torch.cuda.empty_cache()
    x = torch.zeros((8, 2048, 960), device="cuda", dtype=torch.bfloat16)
    tree = {"a": x, "b": {"c": x, "d": x}}
    each = {}
    for h in present:
        fn = next(getattr(m, h) for m in mods if hasattr(m, h))
        if h == "gather_params":
            each[h] = _host_us(lambda: fn(tree), 20000)
        elif h == "row_gather":
            continue          # a real gather: its host time is the index op's
        else:
            each[h] = _host_us(lambda: fn(x), 20000)
    out["hint_us"] = each
    out["hint_calls_per_train_step"] = calls
    out["hint_ms_per_train_step"] = sum(
        each.get(h, 0.0) * calls[h] for h in present) / 1e3
    return out


PARTS = {"train": part_train, "mla_train": part_mla_train,
         "models": part_models, "grad": part_grad, "serve": part_serve,
         "host": part_host}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_ab: needs a CUDA device", file=sys.stderr)
        return 2
    root = str(Path(args.tree).resolve())
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    with ThreadPoolExecutor(len(cs.SOURCES)) as pool:   # one nvcc a source
        list(pool.map(_build.build, cs.SOURCES))
    for name in args.parts.split(","):
        t0 = time.perf_counter()
        res = PARTS[name](cs)
        print(json.dumps({"tree": root, "part": name, **res,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
