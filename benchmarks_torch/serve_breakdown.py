"""Where a serving step's time goes on the GPU (the port's ServeEngine).

    python3 benchmarks_torch/serve_breakdown.py

Builds ``ServeEngine`` with the reference's defaults (8 slots, pages of
16, 512 pages, bf16 KV, ``state_shards=2``) over smollm-360m at its
published widths and depth, bf16 weights from a seeded
``torch.Generator``, and serves ``chip_smoke.py``'s serving traffic
(``serving_prompts``: 16 prompts of 128-512 tokens, 32 new tokens each,
in two waves of 12 and 4, the second holding one prefix hit) twice: on
one engine unprofiled (warm-up), then on a fresh engine (an empty prefix
cache) under ``torch.profiler`` with a ``PhaseTracer(enabled=True,
annotate=True)``, whose spans (``serve/prefill``, ``serve/decode``,
``serve/state_flush`` and the state store's ``plan_phase`` /
``exec_phase`` / ``commit_phase``) synchronise the device at both ends.

Prints per range: calls, host wall ms, device kernel ms, kernel launches,
host-side synchronisations and the device busy share, and the kernels
with the most device time. Needs a GPU; exits non-zero without one or
when the profiler records no device activity.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from breakdown import range_table  # noqa: E402
from chip_smoke import (SERVE_ARCH, SERVE_NEW, WAVE1,  # noqa: E402
                        serving_prompts)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.obs import PhaseTracer  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

RANGES = ("serve/prefill", "serve/decode", "serve/state_flush",
          "plan_phase", "exec_phase", "commit_phase")


def serve(eng, prompts):
    """The two waves of ``chip_smoke.py``'s serving path."""
    for wave in (range(WAVE1), range(WAVE1, len(prompts))):
        for rid in wave:
            eng.submit(rid, prompts[rid], SERVE_NEW)
        eng.run()
    torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    cfg = get_config(SERVE_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    prompts = serving_prompts(cfg.vocab_size)
    serve(ServeEngine(cfg, params), prompts)                 # warm-up
    torch.cuda.empty_cache()
    eng = ServeEngine(cfg, params,
                      tracer=PhaseTracer(enabled=True, annotate=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(eng, prompts)
    rows = range_table(prof, RANGES, ("read/resolve", "serve/logits_at",
                                      "reassign_k", "gc_sweep"))
    if rows is None:
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ranges": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
