"""The port's whole dry run, one process a cell, run in parallel, with
two checks of every ``ok`` cell that do not read the port's counter.

    python3 benchmarks_torch/dryrun_sweep.py                 # everything
    python3 benchmarks_torch/dryrun_sweep.py --sp            # SP train_4k
    python3 benchmarks_torch/dryrun_sweep.py --archs smollm-360m \\
        --meshes local,single --shapes train_4k --jobs 2

Runs ``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M``
for every (architecture x shape x mesh) cell, ``--jobs`` processes at a
time (default: one a CPU core), longest first (train, then the 3-dim
mesh). One process a cell: DTensor keeps state between cells of one
process, so a cell's record would depend on the cells before it. Each
cell's record lands in ``<out>/cells/<arch>|<shape>|<mesh>.json``; a cell
already ``ok`` or ``skipped`` there is not run again (so a second run
only checks again; delete a cell's file to rerun it); cells outside
``specs.cell_supported`` are recorded ``skipped`` without a process. The records are merged into ``<out>/dryrun.json``
(``dryrun_sp.json`` with ``--sp``, which sets
``REPRO_SEQUENCE_PARALLEL=1`` and defaults to the ``train_4k`` cells of
both production meshes: the dry run's cache key has no SP field, so give
an SP sweep an ``--out`` of its own and ``--local-dir`` the other
sweep's, whose local cells check (b) reads).

The checks of each ``ok`` cell:

- (a) ``memory.argument_bytes`` equals ``launch.specs.argument_bytes``:
  rank 0's bytes of parameters, AdamW state (train), batch and cache
  (decode), reckoned from the config's shapes and ``parallel.sharding``'s
  specs with numpy, no step run.
- (b) on a production mesh, the cell's ``dot_flops`` is at least its
  ``local`` cell's times (1 - 1e-6): no shard drops work. The dispatch
  walk counts GLOBAL logical flops (``launch.counting``), so the ratio
  is 1 when the sharded step does the one-card step's products, and
  more where it recomputes; ``dot_flops x devices / local`` is printed
  beside it.

Prints one line a cell (status, seconds, peak GiB per device, the
dominant roofline term of ``launch.roofline``, whether the peak fits the
card's memory, the checks) and one JSON line of totals; exits 1 if a
cell errs or a check fails. The card's memory is
``torch.cuda.get_device_properties(0).total_memory`` where a card is
visible, else 80 GiB. ``--device cpu --reduced`` is the CPU rehearsal
(reduced configs at ``dryrun.REDUCED_SHAPES``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.launch import dryrun, roofline, specs  # noqa: E402

OUT = ROOT / "benchmarks_torch" / "results" / "dryrun_sweep"
MESHES = {"local": {"data": 1, "model": 1},
          "single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
DOT_TOL = 1e-6
SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}
MESH_ORDER = {"multi": 0, "single": 1, "local": 2}


def cell_path(out: Path, key: str) -> Path:
    return out / "cells" / f"{key}.json"


def run_one(key: str, out: Path, device: str, reduced: bool, sp: bool,
            timeout: float) -> dict:
    """One cell in a process of its own; returns its record."""
    arch, shape, mesh = key.split("|")
    path = cell_path(out, key)
    if path.exists():
        rec = json.loads(path.read_text()).get(key, {})
        if rec.get("status") in ("ok", "skipped"):
            return rec
    cfg = reduced_config(arch) if reduced else get_config(arch)
    ok, why = specs.cell_supported(cfg, shape)
    if not ok:
        rec = {"status": "skipped", "reason": why}
        path.write_text(json.dumps({key: rec}, indent=1))
        return rec
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_SEQUENCE_PARALLEL="1" if sp else "0")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--device", device,
           "--out", str(path), "--force"] + (["--reduced"] if reduced
                                              else [])
    t0 = time.time()
    try:
        run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=timeout)
        tail = run.stderr[-1500:]
    except subprocess.TimeoutExpired:
        run, tail = None, f"timed out after {timeout} s"
    if run is None or not path.exists():
        rec = {"status": "error", "error": f"process: {tail}"}
        path.write_text(json.dumps({key: rec}, indent=1))
        return rec
    rec = json.loads(path.read_text())[key]
    rec["process_s"] = round(time.time() - t0, 1)
    path.write_text(json.dumps({key: rec}, indent=1))
    return rec


def residual_bytes(cfg, shape: dict, mesh: str, sp: bool) -> int:
    """Layers x rank 0's tokens x d_model x 2 B: the remat residuals a
    step keeps (a train step; a serving step keeps none)."""
    if shape["kind"] != "train":
        return 0
    sizes = MESHES[mesh]
    dp = sizes.get("pod", 1) * sizes["data"]
    batch = shape["batch"] // dp if shape["batch"] % dp == 0 \
        else shape["batch"]
    seq = shape["seq"]
    if sp and seq % sizes["model"] == 0:
        seq //= sizes["model"]
    return cfg.num_layers * batch * seq * cfg.d_model * 2


def check(results: dict, reduced: bool, sp: bool, card_bytes: int) -> list:
    """Each ok cell's checks and table row (see the module doc)."""
    rows = []
    for key in sorted(results, key=lambda k: (k.split("|")[0],
                                              SHAPE_ORDER[k.split("|")[1]],
                                              k.split("|")[2])):
        rec = results[key]
        arch, shape, mesh = key.split("|")
        row = {"key": key, "status": rec.get("status")}
        rows.append(row)
        if row["status"] != "ok":
            row["note"] = rec.get("reason") or rec.get("error", "")[:300]
            continue
        cfg = reduced_config(arch) if reduced else get_config(arch)
        info = dryrun.REDUCED_SHAPES[shape] if reduced else \
            specs.SHAPES[shape]
        want = specs.argument_bytes(cfg, shape, MESHES[mesh], info)
        mem = rec["memory"]
        row.update(
            seconds=rec.get("process_s", rec["compile_s"]),
            peak_gib=mem["peak_bytes_per_device"] / 2 ** 30,
            fits=mem["peak_bytes_per_device"] <= card_bytes,
            args_bytes=mem["argument_bytes"], args_want=want["total"],
            a_ok=mem["argument_bytes"] == want["total"],
            residual_gib=residual_bytes(cfg, info, mesh, sp) / 2 ** 30,
            dot_flops=rec["jaxpr"]["dot_flops"],
            meta_runs_excluded=rec.get("meta_runs_excluded"))
        row["over_2x"] = mem["peak_bytes_per_device"] > 2 * (
            want["total"] + row["residual_gib"] * 2 ** 30)
        if not reduced:
            r = roofline.analyze_cell(key, rec)
            row["dominant"] = r["dominant"]
            row["terms_ms"] = [round(r[f"t_{t}_s"] * 1e3, 3) for t in
                               ("compute", "memory", "collective")]
        if mesh != "local":
            local = results.get(f"{arch}|{shape}|local", {})
            if local.get("status") == "ok":
                base = local["jaxpr"]["dot_flops"]
                row["b_ratio"] = row["dot_flops"] / base
                row["b_devices_ratio"] = row["dot_flops"] * rec[
                    "devices"] / base
                row["b_ok"] = row["dot_flops"] >= base * (1 - DOT_TOL)
            else:
                row["b_ok"] = None          # no local cell to hold it to
    return rows


def fmt(row: dict) -> str:
    if row["status"] != "ok":
        return f"{row['key']:<44} {row['status']:<8} {row.get('note', '')}"
    b = "" if row.get("b_ok") is None else (
        f" (b) {'ok' if row['b_ok'] else 'FAIL'} ratio "
        f"{row['b_ratio']:.6f} x devices {row['b_devices_ratio']:.1f};")
    dom = f" {row['dominant']} {row['terms_ms']} ms;" if "dominant" in row \
        else ""
    return (f"{row['key']:<44} ok {row['seconds']:>7} s peak "
            f"{row['peak_gib']:.3f} GiB ({'fits' if row['fits'] else 'OVER'}"
            f"; {'> 2x' if row['over_2x'] else '<= 2x'} args + residuals "
            f"{row['residual_gib']:.3f} GiB);{dom} (a) "
            f"{'ok' if row['a_ok'] else 'FAIL'} {row['args_bytes']} / "
            f"{row['args_want']} B;{b}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ALL_ARCHS))
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--meshes", default=None)
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--timeout", type=float, default=3000.0)
    ap.add_argument("--local-dir", default=None,
                    help="another sweep's --out whose local cells (b) "
                    "reads (an --sp sweep runs none of its own)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()        # the cells run from ROOT
    (out / "cells").mkdir(parents=True, exist_ok=True)
    shapes = args.shapes.split(",") if args.shapes else (
        ["train_4k"] if args.sp else list(specs.SHAPES))
    meshes = args.meshes.split(",") if args.meshes else (
        ["single", "multi"] if args.sp else ["local", "single", "multi"])
    keys = ["|".join(c) for c in itertools.product(
        args.archs.split(","), shapes, meshes)]
    keys.sort(key=lambda k: (SHAPE_ORDER[k.split("|")[1]],
                             MESH_ORDER[k.split("|")[2]]))
    t0 = time.time()

    def one(key):
        rec = run_one(key, out, args.device, args.reduced, args.sp,
                      args.timeout)
        print(f"[{rec['status']}] {key} {rec.get('process_s', '')} s",
              flush=True)
        return rec

    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        list(pool.map(one, keys))
    results = {}
    for key in keys:
        path = cell_path(out, key)
        if path.exists():
            results[key] = json.loads(path.read_text())[key]
    local_dir = Path(args.local_dir).resolve() if args.local_dir else out
    for key in list(results):       # (b) reads the local cells, run or not
        a, s, m = key.split("|")
        local = cell_path(local_dir, f"{a}|{s}|local")
        if m != "local" and local.exists():
            results.setdefault(f"{a}|{s}|local", json.loads(
                local.read_text())[f"{a}|{s}|local"])
    merged = out / ("dryrun_sp.json" if args.sp else "dryrun.json")
    merged.write_text(json.dumps(results, indent=1))
    import torch
    card = torch.cuda.get_device_properties(0).total_memory \
        if torch.cuda.is_available() else 80 * 2 ** 30
    rows = check(results, args.reduced, args.sp, card)
    for row in rows:
        print(fmt(row), flush=True)
    ran = [r for r in rows if r["key"] in keys]
    failed = [r["key"] for r in ran if r["status"] == "ok" and (
        not r["a_ok"] or r.get("b_ok") is False)]
    total = {
        "cells": len(ran),
        "ok": sum(r["status"] == "ok" for r in ran),
        "skipped": sum(r["status"] == "skipped" for r in ran),
        "error": sum(r["status"] == "error" for r in ran),
        "checks_failed": failed,
        "b_unchecked": [r["key"] for r in ran if r["status"] == "ok"
                        and r["key"].split("|")[2] != "local"
                        and r.get("b_ok") is None],
        "over_card": [r["key"] for r in ran if r["status"] == "ok"
                      and not r["fits"]],
        "over_2x": [r["key"] for r in ran if r["status"] == "ok"
                    and r["over_2x"]],
        "card_bytes": int(card),
        "sp": args.sp, "seconds": round(time.time() - t0, 1),
        "merged": str(merged)}
    print(json.dumps(total), flush=True)
    return 1 if total["error"] or failed else 0


if __name__ == "__main__":
    sys.exit(main())
