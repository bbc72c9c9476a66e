"""Fault-tolerance primitives: heartbeats, straggler detection, elastic
remesh planning — the port of ``repro.ft.monitor`` (host code only).

The heartbeat store is process-local here, as in the reference, but the
state machine is the deployed one:
  - every worker beats per step; a worker silent for ``timeout_s`` is
    declared failed -> the trainer restores the latest checkpoint version
    onto the surviving devices (``plan_remesh``).
  - per-step durations feed an EWMA straggler detector; a step slower than
    ``threshold`` x the EWMA flags mitigation.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.ewma import EwmaAnomaly as _EwmaAnomaly


def __getattr__(name: str):
    """Deprecation shim, as the reference's: the EWMA estimators live in
    ``repro_torch.obs.ewma``; importing them from here works but warns.
    ``StragglerDetector`` stays; it is the ft-layer wrapper."""
    if name in ("Ewma", "EwmaAnomaly"):
        warnings.warn(
            f"repro_torch.ft.monitor.{name} is deprecated; import it from "
            "repro_torch.obs.ewma",
            DeprecationWarning, stacklevel=2)
        from repro_torch.obs import ewma
        return getattr(ewma, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self.last_beat: Dict[int, Tuple[int, float]] = {}

    def beat(self, step: int, worker: int = 0) -> None:
        self.last_beat[worker] = (step, time.monotonic())

    def failed_workers(self) -> List[int]:
        now = time.monotonic()
        return [w for w, (_, t) in self.last_beat.items()
                if now - t > self.timeout_s]


class StragglerDetector:
    """EWMA of step time; flags steps exceeding threshold x the mean.

    The arithmetic is ``repro_torch.obs.ewma.EwmaAnomaly``'s (flagged
    samples stay out of the baseline); this class keeps the step-indexed
    ``flagged`` list and the ``alpha`` / ``threshold`` / ``ewma`` / ``n``
    attributes.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        self.alpha = alpha
        self.threshold = threshold
        self._anomaly = _EwmaAnomaly(alpha=alpha, threshold=threshold)
        self.flagged: List[int] = []

    @property
    def ewma(self) -> Optional[float]:
        return self._anomaly.baseline

    @property
    def n(self) -> int:
        return self._anomaly.n

    def record(self, dt: float) -> bool:
        slow = self._anomaly.record(dt)
        if slow:
            self.flagged.append(self.n)
        return slow


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    """Elastic-scaling decision after failures: the largest mesh of the
    same axis structure that fits the surviving device count."""
    data: int
    model: int
    pods: int = 1

    @property
    def devices(self) -> int:
        return self.data * self.model * self.pods


def plan_remesh(surviving_devices: int, *, model_parallel: int = 16,
                pods: int = 1) -> RemeshPlan:
    """Keep the model axis fixed (a model shard must fit a device's
    memory), shrink the data axis to the largest power of two that fits,
    per pod."""
    if surviving_devices < model_parallel:
        raise RuntimeError("not enough devices for one model shard")
    per_pod = surviving_devices // pods
    data = max(1, per_pod // model_parallel)
    while data & (data - 1):
        data -= 1
    return RemeshPlan(data=data, model=model_parallel, pods=pods)
