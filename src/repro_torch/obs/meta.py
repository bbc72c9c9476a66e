"""Run metadata stamping — the one shared provenance helper (port of
``repro.obs.meta``).

Every benchmark JSON twin (``benchmarks_torch.common.write_json``) and
arena artifact carries the same ``meta`` block so result trajectories
are comparable across environments: torch and CUDA versions, backend,
device count and name, git SHA when the repo is available, and a wall
timestamp. Failures to read git (no repo, no binary) or the device
degrade to ``None`` — metadata must never make a benchmark fail.
"""
from __future__ import annotations

import platform
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch


def git_sha(cwd: Optional[Path] = None) -> Optional[str]:
    """Short commit SHA of the repo containing ``cwd`` (default: this
    file), or None when unavailable."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=str(cwd or Path(__file__).resolve().parent),
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def _device_fields() -> Dict[str, object]:
    try:
        cuda = torch.cuda.is_available()
        return {"backend": "cuda" if cuda else "cpu",
                "device_count": torch.cuda.device_count() if cuda else 0,
                "device_name": torch.cuda.get_device_name(0) if cuda
                else None}
    except (RuntimeError, AssertionError):
        return {"backend": "cpu", "device_count": 0, "device_name": None}


def run_metadata(extra: Optional[Dict] = None) -> Dict[str, object]:
    """The shared ``meta`` block: environment + provenance."""
    meta: Dict[str, object] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        **_device_fields(),
        "python_version": platform.python_version(),
        "platform": platform.platform(),
        "git_sha": git_sha(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if extra:
        meta.update(extra)
    return meta
