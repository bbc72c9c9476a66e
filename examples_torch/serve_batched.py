"""Batched serving example on the PyTorch/CUDA port (the counterpart of
``examples/serve_batched.py``): continuous batching over the Bohm-MVCC
paged KV cache — requests arrive in waves, share cached prefixes (readers
never block the writers appending new tokens), and pages recycle through
Condition-3 garbage collection.

    python3 examples_torch/serve_batched.py [--device cpu]

Runs on the card by default (the attention kernels serve prefill and
decode); ``--device cpu`` takes their plain PyTorch versions. Parameters
are random, from ``torch.Generator`` seed 0.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402


def main(device=None):
    dev = resolve_device(device)
    # a small llama-family model so the example runs in seconds on CPU
    cfg = dataclasses.replace(
        get_config("smollm-360m"), name="smollm-nano",
        num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=512, vocab_size=2048)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, slots=8, page_size=16, num_pages=256,
                      max_pages_per_seq=32, device=dev)

    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, 2000, 32).astype(np.int32)  # shared
    n_requests = 16
    for rid in range(n_requests):
        user = rng.integers(1, 2000, rng.integers(4, 24)).astype(np.int32)
        prompt = system_prompt if rid % 2 == 0 else \
            np.concatenate([system_prompt[:16], user])
        eng.submit(rid, prompt, max_new_tokens=16)

    t0 = time.perf_counter()
    finished = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    toks = sum(len(r.generated) for r in finished)
    s = eng.sched.stats
    print(f"served {len(finished)} requests / {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.0f} tok/s) over {eng.steps} "
          f"batched decode steps on {dev.type}")
    print(f"prefix-cache hits: {s['prefix_hits']}  "
          f"pages recycled (Condition-3 GC): {s['pages_recycled']}")
    print(f"sample output: {finished[0].generated[:8]} ...")
    return finished, eng


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default the card; cpu for the plain versions")
    main(ap.parse_args().device)
