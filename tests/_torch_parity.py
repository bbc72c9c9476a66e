"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The same numpy inputs go to the JAX reference (``repro``, on the CPU
with Pallas in interpret mode, as its own tests run it) and to the
PyTorch port (``repro_torch``, ``device="cpu"``); results come back as
numpy arrays and are compared byte for byte unless a test states a
tolerance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro.core.engine import BohmEngine as RefEngine
from repro.obs import MetricsRegistry as RefRegistry
from repro_torch.core.txn import TxnBatch as PortBatch

BATCH_FIELDS = ("read_set", "write_set", "txn_type", "args")
_REF_ENGINES = {}


def fresh_ref_engine(num_records: int, name: str, make_workload,
                     auditor=None, **kw):
    """A reference ``BohmEngine`` in its initial state. Engines are cached
    per configuration and reset (store, pins, registry) between uses, so
    their jitted phases compile once per test process, not per test. An
    enabled ``auditor`` keys the cache by its sweep export width (the one
    setting the jitted phases bake in) and is bound to the engine
    returned."""
    audited = auditor is not None and auditor.enabled
    key = (num_records, name, tuple(sorted(kw.items())),
           auditor.gc_event_cap if audited else None)
    eng = _REF_ENGINES.get(key)
    if eng is None:
        eng = _REF_ENGINES[key] = RefEngine(
            num_records, make_workload(),
            auditor=auditor if audited else None, **kw)
    else:
        if audited:
            eng.auditor = auditor
        eng.metrics = RefRegistry()
        eng.reset_store(np.zeros((num_records, eng.workload.payload_words),
                                 np.int32))
    return eng


def np_(x) -> np.ndarray:
    """numpy view of a JAX array, torch tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_batch(batch) -> PortBatch:
    """The port's CPU batch holding the same arrays as ``batch``."""
    return PortBatch(*(torch.tensor(np_(getattr(batch, f)),
                                    dtype=torch.int32)
                       for f in BATCH_FIELDS))


def ref_store_arrays(store) -> dict:
    """Flatten a reference ``Store`` into the port's carry dict."""
    v = store.versions
    out = {"base": store.base, "base_ts": store.base_ts,
           "ts_counter": store.ts_counter, "k_eff": v.k_eff}
    if v.rings is not None:
        out.update(ring_begin=v.rings.begin, ring_end=v.rings.end,
                   ring_payload=v.rings.payload, ring_head=v.rings.head)
    else:
        out.update(page_begin=v.pages.begin, page_end=v.pages.end,
                   page_payload=v.pages.payload,
                   page_table=v.pages.page_table, page_head=v.pages.head)
    if v.spill is not None:
        out.update(spill_begin=v.spill.begin, spill_end=v.spill.end,
                   spill_rec=v.spill.rec, spill_payload=v.spill.payload)
    return {k: np_(a) for k, a in out.items()}


def assert_same(a, b, msg: str = "") -> None:
    """Byte equality (same dtype class, same shape, same values)."""
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, f"{msg}: shape {a.shape} != {b.shape}"
    assert a.dtype.kind == b.dtype.kind or {a.dtype.kind, b.dtype.kind} \
        <= {"i", "u"}, f"{msg}: dtype {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=msg)


def assert_dicts_same(ref: dict, port: dict, msg: str = "",
                      rtol_keys=("ring_occ_mean", "found_frac")) -> None:
    """Same keys; integer entries byte-equal, float gauges to rtol 1e-6
    (float32 means/fractions may be summed in another order)."""
    assert set(ref) == set(port), f"{msg}: keys {set(ref) ^ set(port)}"
    for k in ref:
        if k in rtol_keys:
            np.testing.assert_allclose(np_(port[k]), np_(ref[k]), rtol=1e-6,
                                       err_msg=f"{msg}: {k}")
        else:
            assert_same(ref[k], port[k], f"{msg}: {k}")


def dataclass_arrays(obj) -> dict:
    return {f.name: np_(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def inc_workloads(ops: int, payload_words: int = 2):
    """The scheduler tests' increment workload, as (reference, port): type
    0 adds ``args[0]`` to word 0 of every read record, type 1 only reads.
    The reference's branches run per transaction, the port's batched."""
    import jax.numpy as jnp
    from repro.core.txn import Workload as RefWorkload
    from repro_torch.core.txn import Workload

    def ref_rmw(vals, args):
        return vals.at[..., 0].add(args[0]), jnp.zeros((), bool)

    def ref_read(vals, args):
        return vals, jnp.zeros((), bool)

    def rmw(vals, args):
        out = vals.clone()
        out[..., 0] += args[:, :1]
        return out, torch.zeros(vals.shape[0], dtype=torch.bool,
                                device=vals.device)

    def read(vals, args):
        return vals, torch.zeros(vals.shape[0], dtype=torch.bool,
                                 device=vals.device)

    return (RefWorkload(name="inc", n_read=ops, n_write=ops,
                        payload_words=payload_words,
                        branches=(ref_rmw, ref_read)),
            Workload(name="inc", n_read=ops, n_write=ops,
                     payload_words=payload_words, branches=(rmw, read)))


def assert_rows_same(ref_rows, port_rows, msg: str = "",
                     renamed=None, dropped=()) -> None:
    """Benchmark rows of ``benchmarks/`` and ``benchmarks_torch/`` equal
    in every field that is not a wall time
    (``benchmarks_torch.common.row_mismatches``), after ``renamed`` {ref
    key: port key} and without the reference's ``dropped`` keys."""
    from benchmarks_torch.common import row_mismatches
    renamed = renamed or {}
    ref_rows = [{renamed.get(k, k): v for k, v in r.items()
                 if k not in dropped} for r in ref_rows]
    bad = row_mismatches(ref_rows, port_rows)
    assert not bad, f"{msg}: {bad}"
