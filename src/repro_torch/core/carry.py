"""State carried across: a committed ``Store`` as a flat dict of numpy
arrays.

The port's "weights" are the committed MVCC state. ``store_to_numpy``
flattens a ``Store`` into named numpy arrays and ``store_from_reference``
rebuilds one on a device, so state written by the JAX reference engine
(flattened the same way with ``np.asarray``) or by another port engine
can be adopted by ``BohmEngine.load_state``. The layout is the
reference's, leading shard axis included (n shards of Rl = ceil(R / n)
records each):

    base [R, D], base_ts [R], ts_counter [], k_eff [n, Rl]
    the primary level, exactly one of
      ring_begin / ring_end [n, Rl, K], ring_payload [n, Rl, K, D],
      ring_head [n, Rl]                                  (dense rings)
      page_begin / page_end [n, P, S], page_payload [n, P, S, D],
      page_table [n, Rl, MaxP], page_head [n, Rl]        (paged slab)
    spill_begin / spill_end / spill_rec [n, B, S],
    spill_payload [n, B, S, D]          (absent when spill is off)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.execute import Store
from repro_torch.store.pages import PageSlab
from repro_torch.store.ring import VersionRing
from repro_torch.store.sharded import ShardedVersionStore, full_store
from repro_torch.store.spill import SpillPool

RING_KEYS = ("ring_begin", "ring_end", "ring_payload", "ring_head")
PAGE_KEYS = ("page_begin", "page_end", "page_payload", "page_table",
             "page_head")
SPILL_KEYS = ("spill_begin", "spill_end", "spill_rec", "spill_payload")


def store_from_reference(arrays: Dict[str, np.ndarray], device):
    """Build the port's ``Store`` on ``device`` from the flat dict."""
    def t(name):
        a = np.asarray(arrays[name])
        if a.dtype != np.int32:
            raise TypeError(f"{name}: expected int32 state, got {a.dtype}")
        return torch.tensor(a, device=device)

    if np.min(arrays["k_eff"], initial=1) < 1:
        raise ValueError("k_eff must be >= 1 (ring slot arithmetic is mod "
                         "k_eff)")
    has_rings, has_pages = RING_KEYS[0] in arrays, PAGE_KEYS[0] in arrays
    if has_rings == has_pages:
        raise ValueError("carried state must hold exactly one primary "
                         "level: the ring_* keys or the page_* keys")
    rings = pages = None
    if has_rings:
        rings = VersionRing(*(t(k) for k in RING_KEYS))
        if rings.begin.dim() != 3:
            raise ValueError("carried rings must be [n, Rl, K]")
    else:
        pages = PageSlab(*(t(k) for k in PAGE_KEYS))
        if pages.begin.dim() != 3 or pages.page_table.dim() != 3:
            raise ValueError("carried pages must be [n, P, S] with an "
                             "[n, Rl, MaxP] page table")
    spill = (SpillPool(*(t(k) for k in SPILL_KEYS))
             if SPILL_KEYS[0] in arrays else None)
    base = t("base")
    versions = ShardedVersionStore(rings=rings, spill=spill,
                                   k_eff=t("k_eff"),
                                   num_records=base.shape[0], pages=pages)
    return Store(base=base, base_ts=t("base_ts"),
                 ts_counter=t("ts_counter").reshape(()), versions=versions)


def store_to_numpy(store) -> Dict[str, np.ndarray]:
    """Inverse of ``store_from_reference`` (a version store sharded over
    a mesh is gathered whole on every rank)."""
    v = full_store(store.versions)
    out = {"base": store.base, "base_ts": store.base_ts,
           "ts_counter": store.ts_counter, "k_eff": v.k_eff}
    if v.rings is not None:
        out.update(zip(RING_KEYS, (v.rings.begin, v.rings.end,
                                   v.rings.payload, v.rings.head)))
    else:
        out.update(zip(PAGE_KEYS, (v.pages.begin, v.pages.end,
                                   v.pages.payload, v.pages.page_table,
                                   v.pages.head)))
    if v.spill is not None:
        out.update(zip(SPILL_KEYS, (v.spill.begin, v.spill.end, v.spill.rec,
                                    v.spill.payload)))
    return {k: x.detach().cpu().numpy() for k, x in out.items()}
