"""Serving engine on the card: continuous batching throughput with and
without prefix sharing, the Bohm MVCC read-annotation path (the
counterpart of ``benchmarks/serving.py``).

    python3 benchmarks_torch/serving.py

The reference's smollm-nano (smollm-360m cut to 4 layers, d_model 256, 8
heads over 4 KV heads of 32, d_ff 512, a 2048-token vocabulary), 12
requests of 32 prompt tokens x 12 new tokens over 6 slots of 16-token
pages, unique prompts against one shared prefix, request seed
``default_rng(0)``. Rows in the reference's schema: ``mode``,
``requests``, ``tokens``, ``wall_s``, ``tok_s``, ``prefix_hits``,
``pages_recycled``. After the timed run, one ``lookup`` of every rid
must find each request's progress row with its generated-token count.
On the card a run launches ``flash_attention_causal`` (prefills),
``decode_attention`` (decode steps and prefix hits) and, in ``lookup``,
``mvcc_resolve`` and ``mvcc_resolve_masked``.

Parameters come from ``init_params`` with ``torch.Generator`` seed 0
(the reference's come from ``jax.random.PRNGKey(0)``: other numbers), in
the config's bf16 with the engine's bf16 KV cache. Needs a GPU;
``run(device="cpu")`` is the rehearsal on the CPU.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import card_line, needs_cuda, write_csv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402


def _cfg():
    return dataclasses.replace(
        get_config("smollm-360m"), name="smollm-nano",
        num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=512, vocab_size=2048)


def _run_once(share_prefix: bool, n_requests: int = 12, device=None):
    dev = resolve_device(device)
    cfg = _cfg()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, slots=6, page_size=16, num_pages=256,
                      max_pages_per_seq=32, device=dev)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 2000, 32).astype(np.int32)
    for rid in range(n_requests):
        if share_prefix:
            prompt = shared
        else:
            prompt = rng.integers(1, 2000, 32).astype(np.int32)
        eng.submit(rid, prompt, max_new_tokens=12)
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    # the request-state store agrees with what was served (outside the
    # timed region; a snapshot read through the resolve kernels)
    view = eng.lookup([r.rid for r in done])
    if not (view["known"].all() and list(view["n_generated"])
            == [len(r.generated) for r in done]):
        raise RuntimeError("serving: request-state store disagrees with "
                           "the generated tokens")
    return {
        "mode": "shared_prefix" if share_prefix else "unique_prompts",
        "requests": n_requests, "tokens": toks,
        "wall_s": round(dt, 3), "tok_s": round(toks / dt, 1),
        "prefix_hits": eng.sched.stats["prefix_hits"],
        "pages_recycled": eng.sched.stats["pages_recycled"],
    }


def run(device=None) -> list:
    rows = [_run_once(False, device=device), _run_once(True, device=device)]
    write_csv("serving", rows)
    return rows


def main() -> int:
    if not needs_cuda("serving"):
        return 2
    run()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
