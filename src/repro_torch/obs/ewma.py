"""Exponentially-weighted moving averages for telemetry baselines (port of
``repro.obs.ewma``, host code only).

``Ewma``          the bare estimator: ``v <- (1-alpha) * v + alpha * x``,
                  seeded by the first sample (no bias-correction warmup:
                  a telemetry baseline has a defined value after one
                  sample).
``EwmaAnomaly``   baseline + multiplicative threshold detector: a sample
                  ``x > threshold * baseline`` is flagged AND excluded
                  from the baseline update, so one anomalous sample
                  cannot drag the baseline up and mask the next one.

The tracer's span anomalies (``repro_torch.obs.trace``), the health
monitor's alerts (``repro_torch.obs.monitor``) and the regression gate
(``repro_torch.obs.regress``) share these two classes.
"""
from __future__ import annotations

from typing import Optional


class Ewma:
    """Scalar EWMA, seeded by the first observation."""

    def __init__(self, alpha: float = 0.1):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.value: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> float:
        self.n += 1
        self.value = float(x) if self.value is None else \
            (1.0 - self.alpha) * self.value + self.alpha * float(x)
        return self.value


class EwmaAnomaly:
    """EWMA baseline with a multiplicative anomaly threshold.

    ``record(x)`` returns True when ``x`` exceeds ``threshold`` times the
    current baseline; flagged samples do NOT update the baseline. Before
    any sample lands nothing is anomalous: the first sample seeds the
    EWMA.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        self.ewma = Ewma(alpha)
        self.threshold = threshold
        self.n = 0          # samples offered (flagged ones included)
        self.n_anomalies = 0

    @property
    def baseline(self) -> Optional[float]:
        return self.ewma.value

    def record(self, x: float) -> bool:
        self.n += 1
        baseline = self.ewma.value
        if baseline is not None and x > self.threshold * baseline:
            self.n_anomalies += 1
            return True
        self.ewma.update(x)
        return False
