"""Where a training step's time goes on the GPU (the port's training path).

    python3 benchmarks_torch/train_breakdown.py [--steps 2]

``chip_smoke.py`` phase 15's configuration: smollm-360m at its published
widths and depth, bf16 weights from a seeded ``torch.Generator``, remat
"full", AdamW, B=8 x S=2,048 on ``SyntheticTokenSource``. After one
unprofiled warm-up step, ``--steps`` steps run under ``torch.profiler``,
each as ``make_train_step`` runs it, with the loss and gradient
(``train/loss_and_grad``: forward, remat recompute and backward) and the
optimizer (``train/adamw``) in ranges of their own inside
``train/step``; each range ends in a synchronisation, so the device work
that a range enqueued is counted in it (the profiler places a kernel in
the host range its device time overlaps).

Prints per range: calls, host wall ms, device kernel ms, kernel launches,
host-side synchronisations and the device busy share; the kernels with
the most device time; and the share of the steps' device time spent in
each of the port's attention kernels (the backward's three kernels
apart), in the cuBLAS products and in everything else. Needs a GPU;
exits non-zero without one or when the profiler records no device
activity.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from breakdown import range_table  # noqa: E402
from chip_smoke import TRAIN_ARCH  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (PackedBatchIterator,  # noqa: E402
                                       SyntheticTokenSource)
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_loop import value_and_grad  # noqa: E402

RANGES = ("train/step", "train/loss_and_grad", "train/adamw")
# kernels grouped by fragments of their names; the rest is "other". The
# backward's kernels on either route: the tensor cores' (*_wgmma_kernel,
# csrc/flash_attention_bwd_wgmma.cu) or the CUDA cores' (*_kernel)
GROUPS = {"flash forward (wgmma)": ("flash_wgmma_kernel",),
          "backward: row stats": ("stats_wgmma_kernel", "stats_kernel"),
          "backward: dk, dv": ("dkdv_wgmma_kernel", "dkdv_kernel"),
          "backward: dq": ("dq_wgmma_kernel", "dq_kernel"),
          "cuBLAS products": ("nvjet", "gemm", "cutlass", "xmma")}


def step(params, state, batch, cfg):
    """One ``make_train_step`` step in profiled ranges."""
    with record_function("train/step"):
        with record_function("train/loss_and_grad"):
            loss, grads = value_and_grad(params, batch, cfg)
            torch.cuda.synchronize()
        with record_function("train/adamw"):
            params, state, _ = opt.adamw_update(params, grads, state)
            torch.cuda.synchronize()
    return params, state, float(loss)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    cfg = get_config(TRAIN_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    state = opt.init_opt_state(params)
    data = PackedBatchIterator(SyntheticTokenSource(cfg.vocab_size, seed=0),
                               batch=args.batch, seq_len=args.seq)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(data).items()}
               for _ in range(args.steps + 1)]
    data.close()
    params, state, _ = step(params, state, batches[0], cfg)   # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches[1:]:
            params, state, loss = step(params, state, batch, cfg)
    rows = range_table(prof, RANGES)
    if rows is None:
        return 1
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in RANGES]
    total = sum(k.time_range.elapsed_us() for k in kernels)
    shares = collections.Counter()
    for k in kernels:
        label = next((g for g, frags in GROUPS.items()
                      if any(f in k.name for f in frags)), "other")
        shares[label] += k.time_range.elapsed_us()
    print("share of the steps' device time:")
    for label in (*GROUPS, "other"):
        print(f"  {label:24s} {shares[label] / 1e3 / args.steps:9.3f} ms a "
              f"step  {100 * shares[label] / total:5.1f} %")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": smi,
        "tokens_per_step": args.batch * args.seq, "ranges": rows,
        "device_ms_per_step": total / 1e3 / args.steps,
        "kernel_ms_per_step": {k: v / 1e3 / args.steps
                               for k, v in shares.items()},
        "last_loss": loss}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
