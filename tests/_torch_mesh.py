"""The port-side pieces of the ``cc`` mesh tests' store scenario: the
seeded increment batches, the increment workload, the engine factory,
the state a test compares and the scenario itself. They import nothing
of the reference (nor ``chip_smoke``), so a rank spawned by
``benchmarks_torch.common.spawn_ranks`` stays light. The thread ranks
are ``chip_smoke.thread_ranks(fn, n, device="cpu")``.
"""
from __future__ import annotations

import numpy as np
import torch

OPS = 3
R_STORE = 33


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def inc_batch(seed: int, R: int, T: int = 16):
    """The reference mesh scripts' random batch: T transactions of OPS
    reads, 60 % of them also written; type 0 (increment) or 1 (read)."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, R, (T, OPS))
    writes = np.where(rng.random((T, OPS)) < 0.6, reads, -1)
    return tuple(np.asarray(a, np.int32) for a in (
        reads, writes, rng.integers(0, 2, T), rng.integers(1, 5, (T, 1))))


def port_inc():
    """The scheduler tests' increment workload (``_torch_parity
    .inc_workloads``' port half): type 0 adds ``args[0]`` to word 0 of
    every read record, type 1 only reads."""
    from repro_torch.core.txn import Workload

    def rmw(vals, args):
        out = vals.clone()
        out[..., 0] += args[:, :1]
        return out, torch.zeros(vals.shape[0], dtype=torch.bool,
                                device=vals.device)

    def read(vals, args):
        return vals, torch.zeros(vals.shape[0], dtype=torch.bool,
                                 device=vals.device)

    return Workload(name="inc", n_read=OPS, n_write=OPS, payload_words=2,
                    branches=(rmw, read))


def port_batch(arrays):
    from repro_torch.core.txn import make_batch
    return make_batch(*arrays, device="cpu")


def port_engine(R, wl, mesh=None, **kw):
    from repro_torch.core.engine import BohmEngine
    return BohmEngine(R, wl(), device="cpu", mesh=mesh, **kw)


def port_state(eng):
    """Everything the port exposes of an engine's state, as host values
    (a mesh engine gathers; every rank joins)."""
    from repro_torch.core.carry import store_to_numpy
    counters = {k: v for k, v in eng.metrics.snapshot().items()
                if k.startswith(("engine/", "service/"))}
    return {"store": store_to_numpy(eng.store), "counters": counters,
            "spill_stats": eng.spill_stats(),
            "storage_stats": eng.storage_stats(),
            "overflow_stats": eng.overflow_stats(),
            "k_by_record": np_(eng.k_by_record())}


def store_scenario(eng, conv, unshard_fn):
    """The reference's store mesh script (tests/test_store.py): three
    batches with a pin after the first, the pinned snapshot read, a
    read-only batch, the unsharded rings and the overflow counts."""
    reads, snap = [], None
    for i in range(3):
        r, _ = eng.run_batch(conv(inc_batch(i, R_STORE)))
        reads.append(np_(r))
        if i == 0:
            snap = eng.begin_snapshot()
    out = {"reads": reads, "head": np_(eng.snapshot())}
    v, f = eng.snapshot_read(np.arange(R_STORE), snap)
    out.update(snap_vals=np_(v), snap_found=np_(f))
    vals, found, m = eng.run_readonly_batch(conv(inc_batch(9, R_STORE)))
    out.update(ro_vals=np_(vals), ro_found=np_(found),
               found_frac=float(m["found_frac"]))
    g = unshard_fn(eng.store.versions)
    out.update({f"ring_{f}": np_(getattr(g, f))
                for f in ("begin", "end", "payload", "head")})
    out["overflow"] = np_(eng.overflow_by_record())
    return out


def port_store(mesh):
    """The store scenario on the port: over ``mesh`` (its cc size shards)
    or, with None, on 4 logical shards."""
    from repro_torch.store import unshard
    eng = port_engine(R_STORE, port_inc, mesh=mesh,
                      n_shards=None if mesh is not None else 4)
    assert eng.n_shards == 4
    out = store_scenario(eng, port_batch, unshard)
    out["state"] = port_state(eng)
    return out
