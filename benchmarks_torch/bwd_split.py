"""Device time of each of ``flash_attention_causal_bwd``'s three kernels
(row statistics, dk/dv, dq) on its tensor-core routes — ``wgmma`` in
bf16, ``tf32x3`` in float32 — at the training paths' shapes: where the
backward's time goes.

    python3 benchmarks_torch/bwd_split.py

Each kernel is called alone, through the same C functions the wrapper
calls, on the inputs of one backward (its lse and D from one stats
call), and timed as ``chip_smoke.py`` times a kernel (``_device_ms``:
CUDA events around back-to-back launches, median of rounds); the whole
backward is timed beside them. Prints one JSON line a shape and dtype
with each kernel's µs and share of the three, the flops each does (S,
dP and the products it recomputes: stats 2 Dh a visible pair, dk/dv 8,
dq 6; a float32 product counts once, not as its three tf32 products) and
each one's rate, then the card's name and power limit. Needs a GPU;
exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from repro_torch.kernels import _build  # noqa: E402

#: (B, S, KvH, G, Dh): smollm-360m's step and deepseek-v2-lite's (MLA)
SHAPES = ((8, 2048, 5, 3, 64), (2, 2048, 16, 1, 192), (2, 512, 16, 1, 192))
#: Dh flops each kernel does a visible (query head, key) pair
FLOPS_PER_PAIR = {"stats": 2, "dkdv": 8, "dq": 6}
#: the route each dtype's inputs take at these shapes
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_split: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fm
    _build.build("flash_attention")
    for route in ROUTES.values():
        _build.build(fm._BWD_ROUTES[route][0])
    for shape in SHAPES:
        for dtype, route in ROUTES.items():
            split(cs, fm, shape, dtype, route)
    print(cs.nvidia_smi(), flush=True)
    return 0


def split(cs, fm, shape, dtype, route):
    """Time each kernel of ``route`` alone and the whole backward at
    ``shape`` in ``dtype``; print the JSON line."""
    source, suffix = fm._BWD_ROUTES[route]
    fn = "flash_attention_causal_bwd_{}_" + fm._SUFFIX[dtype] + suffix
    q, k, v, out, dout = cs._bwd_inputs(shape, dtype)
    assert fm.flash_bwd_route(q, k, v, out, dout) == route
    b, s, kvh, g, dh = shape
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device="cuda")
    dvec = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ptrs = {"stats": [q, k, out, dout, lse, dvec],
            "dkdv": [q, k, v, dout, lse, dvec, dk, dv],
            "dq": [q, k, v, dout, lse, dvec, dq]}
    sig = [ctypes.c_int] * 5 + [ctypes.c_float]

    def launch(kernel):
        args = ptrs[kernel]
        _build.call(source, fn.format(kernel),
                    [ctypes.c_void_p] * len(args) + sig,
                    [x.data_ptr() for x in args]
                    + [b, s, kvh, g, dh, dh ** -0.5], q.device)

    pairs = b * kvh * g * s * (s + 1) // 2
    row = {"shape": list(shape), "dtype": str(dtype)[6:], "route": route}
    for kernel in fm.BWD_KERNELS:
        us = cs._device_ms(launch, (kernel,), rounds=11, reps=10) * 1e3
        flops = FLOPS_PER_PAIR[kernel] * dh * pairs
        row[kernel] = {"us": us, "flops": flops,
                       "tflop_s": flops / us / 1e6}
    total = sum(row[k]["us"] for k in fm.BWD_KERNELS)
    for kernel in fm.BWD_KERNELS:
        row[kernel]["share"] = row[kernel]["us"] / total
    row["whole_us"] = cs._device_ms(fm.flash_attention_causal_bwd,
                                    (q, k, v, out, dout), rounds=11,
                                    reps=10) * 1e3
    print(json.dumps(row), flush=True)
    del q, k, v, out, dout, dq, dk, dv, lse, dvec
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
