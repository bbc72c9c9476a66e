"""Device times of the resolve kernels on the GPU (rows 1-3 of PERF.md §6).

    python3 benchmarks_torch/resolve_kernels.py

Builds ``csrc/mvcc_resolve.cu`` (printing ptxas' registers and spills a
kernel) and runs ``chip_smoke.py``'s kernel phase alone: each resolve
kernel in both forms against its plain version, bit for bit, timed beside
it and its bound at the dense and paged paths' store shapes and at an odd
float32 shape, with the old and new read-path call sites. Run from the
root of a tree, it measures that tree's kernels, so two trees compare in
one call (parent, change, change, parent). Prints the card's name and
power limit and one JSON line with each kernel's row. Needs a GPU; exits
non-zero without one.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import kernel_phase, nvidia_smi, ptxas_summary  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("resolve_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__}; tree {ROOT}")
    _, nvcc_out = _build.build("mvcc_resolve")
    for line in ptxas_summary(nvcc_out):
        print(f"ptxas: {line}")
    rows = kernel_phase()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi,
                      "kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
