"""Perf trajectory: benchmark history files + EWMA regression gating
(port of ``repro.obs.regress``, host code only).

A suite's history is an append-only JSON file,

    BENCH_<suite>.json = {"suite": ..., "entries": [
        {"meta": run_metadata(), "metrics": {name: value, ...}}, ...]}

under a root directory the caller names (``history_path(suite, root)``).
Every entry is provenance-stamped by ``repro_torch.obs.meta.run_metadata``
(torch and CUDA versions, device, git sha, timestamp), so a regression
can be traced to the commit and toolchain that produced it. The repo
root's ``BENCH_*.json`` files are the JAX reference's histories: nothing
in the port writes them.

Gating reuses ``repro_torch.obs.ewma.EwmaAnomaly``: the baseline is the
EWMA of the PRIOR entries, and the newest entry is flagged when it
exceeds ``threshold`` x baseline in the regression direction. Direction
is inferred from the metric name (``direction_for``): latency-shaped
metrics (``*_us``, ``*_ms``, ``*_s``) regress upward and are fed to the
detector as-is; throughput-shaped metrics (``*txn_s``, ``vs_*``
speedups, rates) regress downward and are fed as reciprocals (``1/x``
rising past the threshold is ``x`` falling below baseline/threshold).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from repro_torch.obs.ewma import EwmaAnomaly
from repro_torch.obs.meta import run_metadata

HISTORY_PREFIX = "BENCH_"

# name-suffix direction table, first match wins: higher-better checked
# before lower-better because "txn_s" would otherwise match "_s"
_HIGHER_BETTER = ("txn_s", "_per_s", "found_rate", "hit_rate", "speedup")
_HIGHER_BETTER_PREFIXES = ("vs_",)
_LOWER_BETTER = ("_us", "_ms", "_s", "_ns", "us_per_txn", "abort_rate",
                 "_dropped", "_failed", "_lag", "_bytes")


def direction_for(name: str) -> str:
    """``"higher"`` (throughput-shaped: regression = drop) or
    ``"lower"`` (latency-shaped: regression = rise) for a metric name.
    Unknown names default to higher-is-better — headline benchmark
    numbers are overwhelmingly rates."""
    if name.startswith(_HIGHER_BETTER_PREFIXES) or \
            name.endswith(_HIGHER_BETTER):
        return "higher"
    if name.endswith(_LOWER_BETTER):
        return "lower"
    return "higher"


@dataclasses.dataclass(frozen=True)
class Regression:
    """One flagged metric in a suite's newest history entry."""
    suite: str
    metric: str
    value: float            # newest entry's raw value
    baseline: float         # EWMA baseline (raw units, same direction)
    ratio: float            # regression factor (> threshold to flag)
    direction: str          # "higher" | "lower"
    n_entries: int

    def describe(self) -> str:
        verb = "fell" if self.direction == "higher" else "rose"
        return (f"{self.suite}/{self.metric}: {self.value:.6g} {verb} "
                f"{self.ratio:.2f}x past baseline {self.baseline:.6g} "
                f"(n={self.n_entries})")


def history_path(suite: str, root: str) -> str:
    return os.path.join(root, f"{HISTORY_PREFIX}{suite}.json")


def load_history(path: str, suite: Optional[str] = None) -> Dict:
    """Load a history file; a missing file is an empty history (the
    first run of a new suite seeds it)."""
    if not os.path.exists(path):
        return {"suite": suite or "", "entries": []}
    with open(path) as f:
        hist = json.load(f)
    if not isinstance(hist.get("entries"), list):
        raise ValueError(f"{path}: malformed history (no entries list)")
    return hist


def append_entry(path: str, suite: str, metrics: Dict[str, float],
                 meta: Optional[Dict] = None,
                 max_entries: int = 200) -> Dict:
    """Append one provenance-stamped entry and rewrite the file (bounded
    to the newest ``max_entries`` so the committed artifact stays
    review-sized). Returns the appended entry."""
    finite = {k: float(v) for k, v in metrics.items()
              if isinstance(v, (int, float))}
    if not finite:
        raise ValueError(f"no numeric metrics to record for '{suite}'")
    hist = load_history(path, suite)
    hist["suite"] = suite
    entry = {"meta": meta if meta is not None else run_metadata(),
             "metrics": finite}
    hist["entries"] = hist["entries"][-(max_entries - 1):] + [entry]
    with open(path, "w") as f:
        json.dump(hist, f, indent=1, sort_keys=True)
        f.write("\n")
    return entry


def check_history(hist: Dict, threshold: float = 1.5,
                  alpha: float = 0.3,
                  min_entries: int = 3) -> List[Regression]:
    """Gate the NEWEST entry against the EWMA baseline of the prior
    ones, per metric. Metrics with fewer than ``min_entries`` samples
    (counting the newest) are skipped — a two-point history cannot
    distinguish noise from trend. Returns the flagged regressions
    (empty = gate passes)."""
    entries = hist.get("entries", [])
    if len(entries) < min_entries:
        return []
    suite = hist.get("suite", "")
    newest = entries[-1].get("metrics", {})
    out: List[Regression] = []
    for name, value in sorted(newest.items()):
        direction = direction_for(name)
        series = [e["metrics"][name] for e in entries
                  if isinstance(e.get("metrics", {}).get(name),
                                (int, float))]
        if len(series) < min_entries:
            continue
        # feed latency-shaped metrics raw, throughput-shaped as 1/x (a
        # throughput drop IS the reciprocal rising); non-positive values
        # can't be reciprocated — skip the metric rather than mis-gate
        if direction == "higher" and any(x <= 0 for x in series):
            continue
        det = EwmaAnomaly(alpha=alpha, threshold=threshold)
        feed = [x if direction == "lower" else 1.0 / x for x in series]
        for x in feed[:-1]:
            det.record(x)
        if det.record(feed[-1]) and det.baseline:
            baseline = det.baseline if direction == "lower" \
                else 1.0 / det.baseline
            ratio = feed[-1] / det.baseline
            out.append(Regression(suite, name, float(series[-1]),
                                  float(baseline), float(ratio),
                                  direction, len(series)))
    return out
