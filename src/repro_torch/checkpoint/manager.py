"""Versioned, asynchronous checkpoint manager — Bohm's version semantics
applied to parameter state; the port of ``repro.checkpoint.manager`` on
the reference's on-disk layout, so either package restores what the other
wrote, bit for bit.

Every ``save`` creates a new immutable version directory stamped with the
step; the writer never waits for readers and readers never block the
writer (atomic manifest swaps instead of locks). Retired versions are
garbage-collected by a watermark (``keep_last``).

Layout:
    <dir>/step_<N>/<flat param name>.npy     one file per leaf
    <dir>/step_<N>/MANIFEST.json             leaves, dtypes, step, extra
    <dir>/LATEST                             atomic pointer (rename swap)

Leaves are tensors (or numpy arrays); a dtype numpy cannot write is
stored as its bits under its own name in the manifest: bfloat16 as
uint16 (``tensor.view(torch.int16)``), float8 as uint8, as the reference
stores them with ``ml_dtypes``. ``restore(step, device=)`` loads onto one
device (default the card); resharding onto a mesh is not ported.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: dtypes numpy cannot hold: the manifest's name, the torch dtype, and the
#: integer dtypes of their bits (torch's view, numpy's file)
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}
_BY_TORCH = {v[0]: k for k, v in _EXT_DTYPES.items()}


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(numpy array to write, the manifest's dtype name)."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        return x, str(x.dtype)
    x = x.detach().to("cpu", copy=True)  # a snapshot, on either device
    if x.dtype in _BY_TORCH:
        name = _BY_TORCH[x.dtype]
        _, bits, np_bits = _EXT_DTYPES[name]
        return x.contiguous().view(bits).numpy().view(np_bits), name
    arr = x.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, name: Optional[str], device) -> torch.Tensor:
    arr = np.asarray(arr, order="C")            # keeps a 0-d leaf 0-d
    if name in _EXT_DTYPES:
        dtype, bits, _ = _EXT_DTYPES[name]
        if bits == torch.int16:          # torch has no uint16 view
            arr = arr.view(np.int16)
        return torch.from_numpy(arr).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._inflight: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None) -> None:
        """Copy to host memory synchronously (the step's one join), write
        to disk in the background: training is never blocked on IO."""
        host, dtypes = {}, {}
        for k, v in _flatten(state).items():
            host[k], dtypes[k] = _to_host(v)
        meta = {"step": int(step), "leaves": sorted(host),
                "dtypes": dtypes, "extra": extra or {}}
        self.wait()
        if self.async_save:
            self._inflight = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._inflight.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: Dict[str, np.ndarray],
               meta: Dict) -> None:
        vdir = self.dir / f"step_{step:012d}"
        tmp = self.dir / f".tmp_step_{step:012d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for name, arr in host.items():
            np.save(tmp / (name.replace("/", "__") + ".npy"), arr)
        (tmp / "MANIFEST.json").write_text(json.dumps(meta))
        if vdir.exists():
            shutil.rmtree(vdir)
        tmp.rename(vdir)                       # version becomes visible
        latest_tmp = self.dir / ".LATEST.tmp"
        latest_tmp.write_text(vdir.name)
        latest_tmp.rename(self.dir / "LATEST")  # atomic pointer swap
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "LATEST"
        if ptr.exists():
            name = ptr.read_text().strip()
            if (self.dir / name / "MANIFEST.json").exists():
                return int(name.split("_")[1])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device: DeviceLike = None
                ) -> Tuple[int, Dict[str, Any], Dict]:
        """Load a version (default the latest) as tensors on ``device``
        (default the card). Returns (step, state, extra)."""
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        vdir = self.dir / f"step_{step:012d}"
        meta = json.loads((vdir / "MANIFEST.json").read_text())
        dtypes = meta.get("dtypes", {})
        flat = {name: _from_host(
                    np.load(vdir / (name.replace("/", "__") + ".npy")),
                    dtypes.get(name), device)
                for name in meta["leaves"]}
        return int(meta["step"]), _unflatten(flat), meta.get("extra", {})
