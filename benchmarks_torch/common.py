"""Shared benchmark harness utilities of the port (the counterpart of
``benchmarks/common.py``): CSV and JSON twins under
``benchmarks_torch/results/`` in the reference's shape, ``{"meta":
run_metadata(), "rows": [...]}``, a median timer that joins through
``repro_torch.device.fence``, and the card's name and power limit.
"""
from __future__ import annotations

import csv
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.obs import run_metadata

RESULTS_DIR = Path(__file__).resolve().parent / "results"


def _join(out) -> None:
    """``device.fence`` every tensor of a (nested) result."""
    if isinstance(out, torch.Tensor):
        device_mod.fence(out)
    elif isinstance(out, dict):
        for v in out.values():
            _join(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _join(v)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            **kw) -> float:
    """Median wall seconds per call, each joined through
    ``device.fence``."""
    for _ in range(warmup):
        _join(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _join(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def write_csv(name: str, rows: List[Dict], print_rows: bool = True) -> Path:
    """Write rows as CSV and the JSON twin."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.csv"
    if rows:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    write_json(name, rows)
    if print_rows:
        for r in rows:
            print(",".join(f"{k}={v}" for k, v in r.items()), flush=True)
    return path


def write_json(name: str, rows: List[Dict]) -> Path:
    """JSON twin format: ``{"meta": run_metadata(), "rows": [...]}`` —
    every artifact is stamped with the environment that produced it
    (torch and CUDA versions, device, git SHA, timestamp)."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.json"
    with open(path, "w") as f:
        json.dump({"meta": run_metadata(), "rows": rows}, f, indent=2,
                  default=str)
    return path


#: row keys that hold a wall time or a ratio of wall times
WALL_KEYS = ("upd_txn_s", "scan_reads_s", "txn_s", "us_per_txn",
             "rmw_ops_s", "wall_s", "tok_s", "txn_s_vs_drop",
             "txn_s_vs_budget", "pipelined_over_barriered")
#: float row fields, compared to rtol 1e-6 (float32 means and fractions
#: may be summed in another order)
FLOAT_KEYS = ("scan_found_frac", "found_rate", "occ_mean",
              "found_vs_drop", "found_vs_budget")


def is_wall_key(key: str) -> bool:
    return key in WALL_KEYS or key.endswith("_us")


def row_mismatches(want: List[Dict], got: List[Dict],
                   skip=()) -> List[str]:
    """Where two runs' rows differ in a field that is not a wall time (nor
    in ``skip``): the same keys in the same order, integers, strings and
    flags equal, ``FLOAT_KEYS`` to rtol 1e-6. Empty when they agree."""
    if len(want) != len(got):
        return [f"{len(want)} rows != {len(got)}"]
    bad = []
    for i, (w, g) in enumerate(zip(want, got)):
        if list(w) != list(g):
            bad.append(f"row {i}: keys {list(w)} != {list(g)}")
            continue
        for k, v in w.items():
            if is_wall_key(k) or k in skip:
                continue
            if k in FLOAT_KEYS and v != "":
                ok = abs(g[k] - v) <= 1e-6 * abs(v)
            else:
                ok = g[k] == v and isinstance(g[k], bool) == \
                    isinstance(v, (bool, np.bool_))
            if not ok:
                bad.append(f"row {i}: {k} {g[k]!r} != {v!r}")
    return bad


def visible_cards(device=None) -> int:
    """How many ranks a ``cc`` mesh may take here: the visible cards for
    a run on the card, 1 on the CPU (the reference's rule: a mesh row
    only where each rank has a device of its own). Raises where the card
    is asked for and none is visible, as every entry point does."""
    dev = device_mod.resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _rank_main(fn, rank: int, n: int, tmp: str, device_type: str,
               timeout: float, mesh) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import cc_mesh, device_mesh
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=timeout))
    try:
        out = fn(cc_mesh(device_type) if mesh is None
                 else device_mesh(*mesh, device_type))
        (Path(tmp) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, device=None, timeout: float = 600.0,
                mesh=None):
    """Run ``fn(mesh)`` on n spawned processes, one a card over NCCL (over
    gloo for a CPU rehearsal, a rank taking its share of the cores),
    meeting through a file in a temporary directory, with a group timeout
    of ``timeout`` seconds. The mesh is the one-dim ``cc`` mesh over the
    n ranks, or ``launch.mesh.device_mesh(*mesh)`` for ``mesh = (shape,
    axis names)``. Returns the ranks' results in rank order; raises if
    the cards are fewer than the ranks, or if a rank fails or hangs.
    ``fn`` must be picklable (a module-level function or a partial of
    one)."""
    import torch.multiprocessing as mp
    device_type = torch.device("cuda" if device is None else device).type
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks want a card each; "
                         f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, tmp, device_type, timeout,
                                   mesh))
                 for r in range(n)]
        # started together: a start blocks until its child has booted and
        # read its arguments (a pipe's worth and more)
        with ThreadPoolExecutor(n) as pool:
            list(pool.map(lambda p: p.start(), procs))
        deadline = time.monotonic() + 2 * timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = {r: p.exitcode for r, p in enumerate(procs)}
        if hung or any(codes.values()):
            raise RuntimeError(f"{n}-rank mesh run failed: exit codes "
                               f"{codes}, hung ranks {hung}")
        return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                for r in range(n)]


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def needs_cuda(script: str) -> bool:
    """False (with a message) where no CUDA device is visible: the
    benchmarks measure the card and exit 2 without one."""
    if torch.cuda.is_available():
        return True
    print(f"{script}: needs a CUDA device", file=sys.stderr)
    return False


def round_table(rows: List[Dict]) -> List[str]:
    """One line per row: committed txn/s beside the protocol's serial
    steps over the timed stream (rounds for the baselines, waves for
    Bohm) and the wall ms each took."""
    out = []
    for r in rows:
        proxy = dict(kv.split("=", 1) for kv in r["proxy"].split())
        steps = int(proxy.get("rounds", proxy.get("waves", 0)))
        unit = "waves" if "waves" in proxy else "rounds"
        per = f"{r['time_s'] * 1e3 / steps:.3f}" if steps else "-"
        out.append(f"{r['cell']:<26} {r['protocol']:<8} "
                   f"{r['txn_s']:>12.1f} txn/s  {steps:>6} {unit:<6} "
                   f"{per:>8} ms each  abort_rate {r['abort_rate']}  "
                   f"{r['verdict']}")
    return out
