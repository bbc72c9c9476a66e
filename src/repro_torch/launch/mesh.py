"""The hardware model of the card the port runs on: one NVIDIA H100 SXM
(NVIDIA's data sheet and the Hopper architecture white paper; dense
rates, without sparsity, at the full 700 W power limit).

The port of ``repro.launch.mesh``'s hardware constants, for the H100 and
not the reference's TPU: ``chip_smoke.py``'s bounds, the trainer's
share of the bf16 peak (``launch/train.py``) and, later, the roofline
divide by these. Mesh construction (``make_production_mesh``) waits for
the port of ``repro.parallel``.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s per card
PEAK_FLOPS_FP32 = 67e12         # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12                # HBM3 bytes/s per card
NVLINK_BW = 450e9               # NVLink 4 bytes/s each way per card
