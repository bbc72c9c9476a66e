"""The paper's own experiment configurations (§5) as selectable configs.

    from repro_torch.configs.bohm_workloads import YCSB_HIGH_10RMW, build
    eng, batch_gen = build(YCSB_HIGH_10RMW)        # on the GPU
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

from repro_torch.core.engine import BohmEngine
from repro_torch.core.workloads import (gen_smallbank_batch, gen_ycsb_batch,
                                        make_microbench, make_smallbank,
                                        make_ycsb)
from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class BohmWorkloadConfig:
    name: str
    kind: str                    # microbench | ycsb | smallbank
    num_records: int             # customers for smallbank
    batch_size: int
    theta: float = 0.0
    mix: str = "10rmw"           # ycsb: 10rmw | 2rmw8r; smallbank: full |
    #                              balance
    payload_words: int = 2


# paper §5.1: 1M 8-byte records, uniform 10RMW
MICROBENCH = BohmWorkloadConfig("microbench", "microbench", 1_000_000, 2048)
# paper §5.2.1 (Fig 5)
YCSB_LOW_10RMW = BohmWorkloadConfig("ycsb-low-10rmw", "ycsb", 1_000_000,
                                    1024, 0.0, "10rmw", 8)
YCSB_LOW_2RMW8R = BohmWorkloadConfig("ycsb-low-2rmw8r", "ycsb", 1_000_000,
                                     1024, 0.0, "2rmw8r", 8)
# paper §5.2.2 (Fig 6): zipfian theta = 0.9
YCSB_HIGH_10RMW = BohmWorkloadConfig("ycsb-high-10rmw", "ycsb", 1_000_000,
                                     1024, 0.9, "10rmw", 8)
YCSB_HIGH_2RMW8R = BohmWorkloadConfig("ycsb-high-2rmw8r", "ycsb",
                                      1_000_000, 1024, 0.9, "2rmw8r", 8)
# paper §5.3: 100 customers = high contention
SMALLBANK_HIGH = BohmWorkloadConfig("smallbank-high", "smallbank", 100,
                                    2048, mix="full")
SMALLBANK_READONLY = BohmWorkloadConfig("smallbank-readonly", "smallbank",
                                        100, 2048, mix="balance")

ALL_WORKLOADS = {c.name: c for c in [
    MICROBENCH, YCSB_LOW_10RMW, YCSB_LOW_2RMW8R, YCSB_HIGH_10RMW,
    YCSB_HIGH_2RMW8R, SMALLBANK_HIGH, SMALLBANK_READONLY]}


def build(cfg: BohmWorkloadConfig, seed: int = 0, mesh=None,
          device: DeviceLike = None) -> Tuple[BohmEngine, Callable]:
    """Returns (engine, batch_gen() -> TxnBatch on the engine's device).
    ``device=None`` is the GPU (raises without one)."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "microbench":
        wl = make_microbench()
        eng = BohmEngine(cfg.num_records, wl, mesh=mesh, device=device)
        gen = lambda: gen_ycsb_batch(rng, cfg.batch_size, cfg.num_records,
                                     theta=0.0, mix="10rmw",
                                     device=eng.device)
    elif cfg.kind == "ycsb":
        wl = make_ycsb(payload_words=cfg.payload_words)
        eng = BohmEngine(cfg.num_records, wl, mesh=mesh, device=device)
        gen = lambda: gen_ycsb_batch(rng, cfg.batch_size, cfg.num_records,
                                     theta=cfg.theta, mix=cfg.mix,
                                     device=eng.device)
    elif cfg.kind == "smallbank":
        wl = make_smallbank()
        eng = BohmEngine(max(2 * cfg.num_records, 2), wl, mesh=mesh,
                         device=device)
        mixes = {"full": (0.2,) * 5, "balance": (1.0, 0, 0, 0, 0)}
        gen = lambda: gen_smallbank_batch(rng, cfg.batch_size,
                                          cfg.num_records,
                                          mix=mixes[cfg.mix],
                                          device=eng.device)
    else:
        raise ValueError(cfg.kind)
    return eng, gen
