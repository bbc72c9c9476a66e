"""Streaming quantiles: a fixed-bucket log histogram (port of
``repro.obs.quantiles``, a copy: the port imports nothing of the JAX
package).

The flight recorder needs per-latency-class p50/p99 over an unbounded
ticket stream without keeping the samples. A fixed-bucket histogram with
geometrically spaced edges gives both properties of interest:

  * O(1) ``add`` (one log + one clip, no allocation, no device work —
    the recorder calls it on the host at ticket completion);
  * bounded relative error: a sample in bucket j lies in
    ``[lo * growth**j, lo * growth**(j+1))``, so any quantile read back
    as the bucket's geometric midpoint is within a factor of
    ``sqrt(growth)`` of the true order statistic. The default
    ``growth = 2**(1/8)`` (8 buckets per octave) keeps that under ~4.4%
    across the full range.

Values below ``lo`` clamp into bucket 0, values above the top edge into
the last bucket (both counted in ``clamped`` — a digest that saturates
tells you so instead of silently lying). ``quantile`` interpolates the
cumulative count linearly INSIDE the selected bucket, which keeps
adjacent quantiles monotonic and tightens the midpoint error for
well-populated buckets.

The digest is a plain host object: merging two digests (same layout) is
element-wise counter addition, and ``to_dict`` / ``from_dict`` round-trip
it through benchmark JSON artifacts.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence


class LogHistogram:
    """Fixed-bucket log-spaced histogram with streaming quantile reads."""

    __slots__ = ("lo", "growth", "n_buckets", "counts", "count",
                 "total", "min", "max", "clamped", "_log_growth", "_hi")

    def __init__(self, lo: float = 1e-6, growth: float = 2.0 ** 0.125,
                 n_buckets: int = 256):
        if lo <= 0.0:
            raise ValueError("lo must be positive")
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        if n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")
        self.lo = float(lo)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        self._log_growth = math.log(self.growth)
        self._hi = self.lo * self.growth ** self.n_buckets
        self.counts: List[int] = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0          # exact running sum (mean stays exact)
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.clamped = 0

    # -- recording ---------------------------------------------------------
    def bucket_of(self, x: float) -> int:
        """Bucket index for ``x`` (clamped to the edge buckets)."""
        if x < self.lo:
            return 0
        j = int(math.log(x / self.lo) / self._log_growth)
        return min(j, self.n_buckets - 1)

    def add(self, x: float, n: int = 1) -> None:
        x = float(x)
        if x < self.lo or x >= self._hi:
            self.clamped += n
        self.counts[self.bucket_of(x)] += n
        self.count += n
        self.total += x * n
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.add(x)

    def merge(self, other: "LogHistogram") -> None:
        """Element-wise merge (layouts must match)."""
        if (other.lo, other.growth, other.n_buckets) != \
                (self.lo, self.growth, self.n_buckets):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        for j, c in enumerate(other.counts):
            self.counts[j] += c
        self.count += other.count
        self.total += other.total
        self.clamped += other.clamped
        for attr, pick in (("min", min), ("max", max)):
            theirs = getattr(other, attr)
            if theirs is not None:
                mine = getattr(self, attr)
                setattr(self, attr,
                        theirs if mine is None else pick(mine, theirs))

    # -- reads -------------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def _edges(self, j: int) -> tuple:
        return (self.lo * self.growth ** j, self.lo * self.growth ** (j + 1))

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 100] percent), interpolated inside
        its bucket; exact at the recorded min/max endpoints."""
        if not 0.0 <= q <= 100.0:
            raise ValueError("q is a percentile in [0, 100]")
        if self.count == 0:
            return 0.0
        if q == 0.0:
            return self.min
        if q == 100.0:
            return self.max
        target = q / 100.0 * self.count
        seen = 0
        for j, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo_e, hi_e = self._edges(j)
                frac = (target - seen) / c
                val = lo_e + (hi_e - lo_e) * frac
                # stay inside the observed range: the edge buckets absorb
                # clamped samples whose true values lie outside them
                return min(max(val, self.min), self.max)
            seen += c
        return self.max

    def quantiles(self, qs: Sequence[float] = (50.0, 99.0)) -> List[float]:
        return [self.quantile(q) for q in qs]

    @property
    def rel_error(self) -> float:
        """Worst-case relative quantile error of this bucket layout."""
        return self.growth - 1.0

    # -- (de)serialisation -------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        nz = {str(j): c for j, c in enumerate(self.counts) if c}
        return {"lo": self.lo, "growth": self.growth,
                "n_buckets": self.n_buckets, "counts": nz,
                "count": self.count, "total": self.total,
                "min": self.min, "max": self.max, "clamped": self.clamped}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "LogHistogram":
        h = cls(lo=d["lo"], growth=d["growth"], n_buckets=d["n_buckets"])
        for j, c in d["counts"].items():
            h.counts[int(j)] = int(c)
        h.count = int(d["count"])
        h.total = float(d["total"])
        h.min = d["min"]
        h.max = d["max"]
        h.clamped = int(d["clamped"])
        return h
