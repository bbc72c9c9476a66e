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
stores them with ``ml_dtypes``.

Sharded state (the elastic restart): a ``DTensor`` leaf is saved whole.
Every rank of its mesh calls ``save`` with the same tree; each leaf is
gathered (``full_tensor()``, a collective, on the caller's thread) and
only global rank 0 writes, the same files and manifest as an unsharded
save. ``wait()`` and a synchronous ``save`` return on every rank only
once the version is complete on disk (a barrier over the leaves' mesh),
so a later world never finds a half-written step. ``restore(step,
shardings=, device=)`` reshards onto a new mesh, as the reference's
``jax.device_put(arr, sharding)``: a leaf with a sharding
(``parallel.spec.NamedSharding``) becomes a ``DTensor`` on its mesh,
each rank reading only its own shard of the file (memory-mapped), and a
leaf without one loads whole onto ``device`` (default the card).
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

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


def _gather(x: DTensor) -> torch.Tensor:
    """A ``DTensor`` whole on every rank of its mesh (a collective); a
    float8 travels as its uint8 bits (gloo carries no float8, nor int16,
    but bfloat16 itself)."""
    if x.element_size() != 1 or x.dtype not in _BY_TORCH:
        return x.full_tensor()
    as_bits = DTensor.from_local(
        x.to_local().view(torch.uint8), x.device_mesh, x.placements,
        run_check=False, shape=x.shape, stride=x.stride())
    return as_bits.full_tensor().view(x.dtype)


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(numpy array to write, the manifest's dtype name); a ``DTensor``
    gathered whole first."""
    if isinstance(x, DTensor):
        x = _gather(x)
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


def _meshes(leaves) -> List[Any]:
    """The distinct meshes of the ``DTensor`` leaves, in order."""
    out: List[Any] = []
    for x in leaves:
        if isinstance(x, DTensor) and all(
                x.device_mesh is not m for m in out):
            out.append(x.device_mesh)
    return out


def _barrier(meshes) -> None:
    """Return once every rank of each mesh has reached it: an all-reduce
    over each mesh dim in turn, read back on the host."""
    import torch.distributed as dist
    for mesh in meshes:
        for d in range(mesh.ndim):
            t = torch.zeros(1, device=_mesh_device(mesh))
            dist.all_reduce(t, group=mesh.get_group(d))
            t.item()


def _mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _shard(path: Path, name: Optional[str], sharding) -> DTensor:
    """This rank's shard of a saved leaf as a ``DTensor`` placed by
    ``sharding``: only the shard's slice of the memory-mapped file is
    read."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    arr = np.load(path, mmap_mode="r")
    pl = sharding.placements
    local, offset = compute_local_shape_and_global_offset(
        arr.shape, sharding.mesh, pl)
    part = np.array(arr[tuple(slice(o, o + n)
                              for o, n in zip(offset, local))], order="C")
    stride = torch.empty(arr.shape, device="meta").stride()
    return DTensor.from_local(
        _from_host(part, name, _mesh_device(sharding.mesh)), sharding.mesh,
        pl, run_check=False, shape=torch.Size(arr.shape), stride=stride)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._inflight: Optional[threading.Thread] = None
        self._pending: List[Any] = []      # meshes the last save spans

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None) -> None:
        """Copy to host memory synchronously (the step's one join), write
        to disk in the background: training is never blocked on IO. With
        ``DTensor`` leaves every rank of their mesh calls this; the
        leaves are gathered here and global rank 0 writes."""
        flat = _flatten(state)
        meshes = _meshes(flat.values())
        writer = not meshes or torch.distributed.get_rank() == 0
        host, dtypes = {}, {}
        for k, v in flat.items():
            if writer:
                host[k], dtypes[k] = _to_host(v)
            elif isinstance(v, DTensor):
                _gather(v)                  # this rank's part of the gather
        meta = {"step": int(step), "leaves": sorted(host),
                "dtypes": dtypes, "extra": extra or {}}
        self.wait()
        self._pending = meshes
        if writer and self.async_save:
            self._inflight = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._inflight.start()
        elif writer:
            self._write(step, host, meta)
        if not self.async_save:
            self.wait()

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
        """Until the last save is on disk; after a sharded save, on every
        rank of its mesh."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._pending:
            meshes, self._pending = self._pending, []
            _barrier(meshes)

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

    def restore(self, step: Optional[int] = None,
                shardings: Optional[Dict] = None, device: DeviceLike = None
                ) -> Tuple[int, Dict[str, Any], Dict]:
        """Load a version (default the latest); optionally reshard onto a
        new mesh (elastic restart). ``shardings`` is a tree of
        ``NamedSharding``s in the state's names: each leaf it names becomes
        a ``DTensor`` on that sharding's mesh; every other leaf loads
        whole onto ``device`` (default the card). Returns (step, state,
        extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        vdir = self.dir / f"step_{step:012d}"
        meta = json.loads((vdir / "MANIFEST.json").read_text())
        flat_sh = _flatten(shardings) if shardings else {}
        dtypes = meta.get("dtypes", {})
        flat = {}
        for name in meta["leaves"]:
            path = vdir / (name.replace("/", "__") + ".npy")
            sh = flat_sh.get(name)
            if sh is not None:
                flat[name] = _shard(path, dtypes.get(name), sh)
            else:                   # resolved here: a sharded restore
                device = resolve_device(device)     # needs no card
                flat[name] = _from_host(np.load(path), dtypes.get(name),
                                        device)
        return int(meta["step"]), _unflatten(flat), meta.get("extra", {})
