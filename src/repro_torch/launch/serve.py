"""Serving launcher: continuous batching over the Bohm-MVCC paged KV
cache — the port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --reduced --requests 8 --max-new 16

Runs on the card (``--device cuda``, the default: every prefill through
``flash_attention_causal``, every decode step through
``decode_attention``) or, when asked, on the CPU. Parameters are random,
from ``torch.Generator`` seed ``--seed``; prompts from numpy's. On the
card the kernels are built before the timer starts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import fence, resolve_device
from repro_torch.kernels import _build
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ServeEngine, check_supported


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else \
        get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    try:
        check_supported(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"serve launcher supports the dense GQA family; "
                         f"{cfg.name} is {cfg.family}") from e
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    eng = ServeEngine(cfg, params, slots=args.slots,
                      page_size=args.page_size,
                      num_pages=max(256, args.requests * 8),
                      max_pages_per_seq=64, device=device)
    if device.type == "cuda":       # nvcc at first use: not in the timer
        for name in ("decode_attention", "flash_attention", "mvcc_resolve"):
            _build.load(name)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              args.prompt_len).astype(np.int32)
        eng.submit(rid, prompt, max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    done = eng.run()
    fence(params["embed"])
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s) on {device}; "
          f"stats={dict(eng.sched.stats)}")


if __name__ == "__main__":
    main()
