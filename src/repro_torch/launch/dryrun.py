"""Multi-card dry run (the port of ``repro.launch.dryrun``): run every
(arch x input-shape) cell's step on abstract tensors over the production
meshes, and record memory / cost / collective analysis for the roofline.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single                              # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh local \\
        --device cpu --reduced                          # CPU rehearsal

Results are cached incrementally in benchmarks_torch/results/dryrun.json
by the key ``arch|shape|mesh``; a cached ``ok`` or ``skipped`` cell is not
run again without ``--force``.

Where the reference lowers and compiles with XLA over 512 forced host
devices, the port runs the step itself (``launch.specs.build_cell``)
under a ``FakeTensorMode``: parameters, optimizer state, batch and cache
are ``DTensor``s over fake local shards (rank 0's), placed by
``parallel.sharding``; the mesh runs over torch's fake process group
(``launch.mesh``), so collectives move nothing; the activation hints are
on (``parallel.constraints.activation_mesh``, sequence parallelism when
``REPRO_SEQUENCE_PARALLEL=1``, as the reference reads it). Plain tensors
the model makes (positions, masks) join as replicated
(``implicit_replication``). Nothing is allocated; the device is the card
unless ``--device cpu`` (on a fake ``cuda`` tensor the attention takes
the kernels' operators; on the CPU, the blockwise code). ``--mesh
local`` is the one-card (1, 1) mesh.

A record keeps the reference's schema: ``lower_s`` is the time to build
the abstract cell, ``compile_s`` the time of the counted run; ``memory``
comes from the live bytes of the fake local shards (``PeakTracker``:
every storage an op makes on this rank, freed when its last tensor dies)
— ``argument_bytes`` the inputs', ``output_bytes`` the results',
``alias_bytes`` the results' that are inputs' storages (a decode step
writes its cache in place), ``peak_bytes_per_device`` the peak and
``temp_bytes`` the rest; ``cost`` repeats the dispatch walk's flops and
bytes (the port has no compiler cost analysis); ``jaxpr`` is
``counting.dispatch_costs`` (name kept for the roofline);
``collectives`` is ``counting.collective_costs`` of what DTensor issued.
A cell that fails — DTensor has no strategy for an op, say — is
recorded as ``{"status": "error", "error", "op", "trace"}``, never
patched over.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.counting import (collective_costs,
                                         collective_counter, dispatch_costs)
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "benchmarks_torch" / "results"

#: the CPU rehearsal's cells (``--reduced``): the reduced configs at
#: these sizes, under the full cells' names
REDUCED_SHAPES = {
    "train_4k": dict(seq=256, batch=4, kind="train"),
    "prefill_32k": dict(seq=256, batch=2, kind="prefill"),
    "decode_32k": dict(seq=256, batch=4, kind="decode"),
    "long_500k": dict(seq=512, batch=1, kind="decode"),
}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's own local tensor (not ``to_local()``'s fresh alias,
    which dies at once), else ``t``."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


class PeakTracker(TorchDispatchMode):
    """Live bytes of this rank's tensors: each storage an op returns
    counts from its first tensor until its last is collected. Enter it
    BELOW a ``DTensor``-aware mode (before it), so it sees the local
    shards."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def _drop(self, key):
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def hold(self, t: torch.Tensor) -> None:
        t = _local(t)
        cdata, nbytes = _storage_key(t)
        entry = self._refs.get(cdata)
        if entry is None:
            entry = self._refs[cdata] = [nbytes, 0]
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._drop, cdata)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.hold(t)
        return out


def _bytes(tree) -> int:
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            cdata, nbytes = _storage_key(_local(t))
            seen[cdata] = nbytes
    return sum(seen.values())


def _storages(tree):
    return {_storage_key(_local(t))[0] for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def _failed_op(err: str) -> Optional[str]:
    m = re.search(r"(aten\.[\w.]+|repro_torch\.[\w.]+|"
                  r"_c10d_functional\.[\w.]+)", err)
    return m.group(1) if m else None


@contextlib.contextmanager
def _strided_offsets_unfaked():
    """torch's DTensor computes a ``_StridedShard``'s local offsets with
    ``torch.arange(n)...tolist()`` while it prices redistributions; with
    a ``FakeTensorMode`` on the stack that ``arange`` is fake and
    ``tolist`` raises a data-dependent error. Its inputs are ints, so the
    dry run runs it with the fake mode unset (the function is restored
    on exit)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.__dict__["local_shard_size_and_offset"]
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    @functools.wraps(fn)
    def unfaked(*a, **kw):
        with unset_fake_temporarily():
            return fn(*a, **kw)

    _StridedShard.local_shard_size_and_offset = (
        staticmethod(unfaked) if isinstance(orig, staticmethod) else unfaked)
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def make_mesh(mesh_kind: str, device=None):
    if mesh_kind == "local":
        return make_local_mesh(device)
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device=device)


def measure(fn, args, fake_mode, mesh=None,
            sequence_parallel: bool = False) -> dict:
    """Runs ``fn(*args)`` on abstract ``args`` (of ``fake_mode``) under the
    fake mode, the activation hints of ``mesh`` (none without one) and
    implicit replication, and returns ``{"jaxpr": dispatch costs,
    "kernels", "collectives", "memory", "compile_s"}`` (see the module
    doc)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel.constraints import activation_mesh
    t0 = time.time()
    tracker = PeakTracker()
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            tracker.hold(t)
    arg_bytes = tracker.live
    counter = collective_counter()
    hints = activation_mesh(mesh, sequence_parallel) if mesh is not None \
        else contextlib.nullcontext()
    holder = {}

    def step(*a):
        holder["out"] = fn(*a)
        return holder["out"]

    with fake_mode, tracker, implicit_replication(), \
            _strided_offsets_unfaked(), hints, counter:
        jc = dispatch_costs(step, *args)
    out = holder.pop("out")
    out_bytes = _bytes(out)
    arg_storages = _storages(args)
    alias = _bytes([t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                    and _storage_key(_local(t))[0] in arg_storages])
    peak = max(tracker.peak, arg_bytes + out_bytes - alias)
    kernels = jc.pop("kernels")
    return {
        "compile_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(peak - arg_bytes - out_bytes + alias),
            "alias_bytes": int(alias),
            "peak_bytes_per_device": int(peak),
        },
        "jaxpr": {k: float(v) for k, v in jc.items()},
        "kernels": kernels,
        "collectives": collective_costs(counter.records),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, device=None,
             reduced: bool = False) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = make_mesh(mesh_kind, device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    ok, why = specs_mod.cell_supported(cfg, shape_name)
    if not ok:
        return {"status": "skipped", "reason": why}
    shape = REDUCED_SHAPES[shape_name] if reduced else None
    sp = os.environ.get("REPRO_SEQUENCE_PARALLEL", "0") == "1"
    fake = FakeTensorMode()
    t0 = time.time()
    fn, args, cfg = specs_mod.build_cell(arch, shape_name, mesh, cfg=cfg,
                                         shape=shape, device=device,
                                         fake_mode=fake)
    t_lower = time.time() - t0
    m = measure(fn, args, fake, mesh, sp)
    jc = m["jaxpr"]
    return {
        "status": "ok",
        "lower_s": round(t_lower, 1),
        "compile_s": m["compile_s"],
        "devices": int(mesh.size()),
        "memory": m["memory"],
        "cost": {"flops": jc["flops"], "bytes accessed": jc["bytes"]},
        "jaxpr": jc,
        "kernels": m["kernels"],
        "collectives": m["collectives"],
        "model": {"params": int(cfg.num_params()),
                  "active_params": int(cfg.num_active_params())},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "local"])
    ap.add_argument("--out", default=str(RESULTS / "dryrun.json"))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs at REDUCED_SHAPES (CPU rehearsal)")
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    shapes = [args.shape] if args.shape else list(specs_mod.SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = f"{arch}|{shape}|{mesh_kind}"
                if key in results and not args.force and \
                        results[key].get("status") in ("ok", "skipped"):
                    print(f"[cached] {key}", flush=True)
                    continue
                print(f"[run]    {key} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind,
                                   device=args.device, reduced=args.reduced)
                except Exception as e:  # noqa: BLE001 — record and continue
                    res = {"status": "error", "error": repr(e)[:2000],
                           "op": _failed_op(repr(e)),
                           "trace": traceback.format_exc()[-2000:]}
                results[key] = res
                out_path.write_text(json.dumps(results, indent=1))
                status = res["status"]
                extra = ""
                if status == "ok":
                    gb = res["memory"]["peak_bytes_per_device"] / 2**30
                    extra = (f" peak={gb:.2f}GiB/dev "
                             f"flops={res['cost'].get('flops', 0):.3g} "
                             f"coll={res['collectives']['total_bytes']:.3g}B "
                             f"run={res['compile_s']}s")
                elif status == "error":
                    extra = f" op={res['op']} " + res["error"][:200]
                print(f"[{status}] {key}{extra}", flush=True)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)


if __name__ == "__main__":
    main()
