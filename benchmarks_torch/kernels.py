"""Kernel micro-benchmarks on the card: each hand-written kernel against
its plain PyTorch version (the counterpart of ``benchmarks/kernels.py``).

    python3 benchmarks_torch/kernels.py

The reference's two rows, seed (``default_rng(0)``) and shapes:

  mvcc_resolve      windows form, b4096 k8 d64 (int32, consistent
                    windows: sorted begins, each end the next begin);
  decode_attention  float32, b8 kv4 g4 dh128 t2048, masked at random
                    kv lengths.

Each row holds the kernel's output against the plain version's
(``allclose``: resolve bit for bit in values and found flags, decode to
1e-4) and their median wall times per call, joined through
``device.fence`` (``common.time_fn``). Columns differ from the
reference's: ``ref_us`` / ``pallas_us`` are ``plain_us`` / ``kernel_us``
here, ``backend`` is the tensors' device type, and ``interpret`` is gone
(the port has no interpret mode: a CUDA tensor launches the kernel, a
CPU tensor takes the plain version, so on the CPU both columns time the
plain version). Needs a GPU; ``run(device="cpu")`` is the rehearsal on
the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks_torch.common import (card_line, needs_cuda,  # noqa: E402
                                     time_fn, write_csv)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

INF = np.iinfo(np.int32).max


def run(device=None) -> list:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []

    b, k, d = 4096, 8, 64
    begin = np.sort(rng.integers(0, 100, (b, k)).astype(np.int32), axis=1)
    end = np.concatenate([begin[:, 1:], np.full((b, 1), INF, np.int32)],
                         axis=1)
    data = rng.integers(0, 100, (b, k, d)).astype(np.int32)
    ts = rng.integers(0, 120, b).astype(np.int32)
    a = [torch.from_numpy(x).to(dev) for x in (begin, end, data, ts)]
    t_plain = time_fn(ops.mvcc_resolve_plain, *a)
    t_kernel = time_fn(ops.mvcc_resolve, *a)
    v1, f1 = ops.mvcc_resolve(*a)
    v2, f2 = ops.mvcc_resolve_plain(*a)
    ok = bool(torch.equal(v1, v2) and torch.equal(f1, f2))
    rows.append({"kernel": "mvcc_resolve", "shape": f"b{b}_k{k}_d{d}",
                 "backend": dev.type, "plain_us": round(t_plain * 1e6),
                 "kernel_us": round(t_kernel * 1e6), "allclose": ok})

    b, kvh, g, dh, t = 8, 4, 4, 128, 2048
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, dh))).float()
    kk = torch.from_numpy(rng.standard_normal((b, t, kvh, dh))).float()
    vv = torch.from_numpy(rng.standard_normal((b, t, kvh, dh))).float()
    kl = torch.from_numpy(rng.integers(1, t, b).astype(np.int32))
    q, kk, vv, kl = (x.to(dev) for x in (q, kk, vv, kl))
    t_plain = time_fn(ops.decode_attention_plain, q, kk, vv, kl)
    t_kernel = time_fn(ops.decode_attention, q, kk, vv, kl)
    o1 = ops.decode_attention(q, kk, vv, kl)
    o2 = ops.decode_attention_plain(q, kk, vv, kl)
    ok = bool(torch.allclose(o1, o2, rtol=1e-5, atol=1e-4))
    rows.append({"kernel": "decode_attention",
                 "shape": f"b{b}_kv{kvh}_g{g}_dh{dh}_t{t}",
                 "backend": dev.type, "plain_us": round(t_plain * 1e6),
                 "kernel_us": round(t_kernel * 1e6), "allclose": ok})
    write_csv("kernels", rows)
    return rows


def main() -> int:
    if not needs_cuda("kernels"):
        return 2
    rows = run()
    print(card_line())
    return 0 if all(r["allclose"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
