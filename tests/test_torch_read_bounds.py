"""Reads of record ids outside [0, R): the port against the JAX reference.

The reference clamps every gather, as XLA does: an id past the store
reads its shard's last row, a negative one row 0 (``repro/store/ring.py``
``gather_windows``, ``pages.py::gather_windows_paged``,
``sharded.py::_resolve_two_level`` / ``gather_windows_sharded``), while
the spill pool's owner test takes the id unclamped above, so it never
matches there. The port's callers clamp the same way (its kernels keep
their own rule: a row outside the array gives found = False). The same
seeded stream runs through a reference engine and a port engine
(``device="cpu"``) in dense and paged storage, with 1 and 2 shards and
the spill tier on; then ``snapshot_read``, ``run_readonly_batch`` (a scan
batch whose read set holds the ids) and ``snapshot_windows`` of ids
{R, R+3, 2R+1, -1, -5} mixed with in-range ids must be byte-equal.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, fresh_ref_engine, port_batch
from repro.core import workloads as ref_wl
from repro.core.txn import make_batch as ref_make_batch
from repro_torch.core import workloads as port_wl
from repro_torch.core.engine import BohmEngine

R = 120
SPILL = dict(spill_buckets=8, spill_slots=8)
CONFIGS = {
    "dense": dict(ring_slots=2, **SPILL),
    "dense-2-shards": dict(ring_slots=2, n_shards=2, **SPILL),
    "paged": dict(ring_slots=4, paged=True, page_slots=2,
                  pages_per_shard=200, **SPILL),
    "paged-2-shards": dict(ring_slots=4, paged=True, page_slots=2,
                           pages_per_shard=100, n_shards=2, **SPILL)}
OUTSIDE = [R, R + 3, 2 * R + 1, -1, -5]


def _engines(kw):
    ref = fresh_ref_engine(R, "ycsb2x4",
                           lambda: ref_wl.make_ycsb(payload_words=2, ops=4),
                           **kw)
    port = BohmEngine(R, port_wl.make_ycsb(payload_words=2, ops=4),
                      device="cpu", **kw)
    rng = np.random.default_rng(21)
    for i in range(3):
        batch = ref_wl.gen_ycsb_batch(rng, 40, R, theta=0.9, ops=4)
        ref.run_batch(batch)
        port.run_batch(port_batch(batch))
        if i == 0:
            pins = ref.begin_snapshot(), port.begin_snapshot()
    return ref, port, pins


def _ids(seed):
    """The ids outside the store, each beside in-range ids, shuffled."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([OUTSIDE, [0, 1, R - 2, R - 1],
                          rng.integers(0, R, 11)])
    return rng.permutation(ids).astype(np.int32)


@pytest.mark.parametrize("name", CONFIGS)
def test_reads_outside_the_store_match_reference(name):
    ref, port, (r_pin, p_pin) = _engines(CONFIGS[name])
    ids = _ids(len(name))
    for r_ts, p_ts, what in ((r_pin, p_pin, "pin"), (None, None, "head")):
        for a, b in zip(ref.snapshot_read(ids, r_ts),
                        port.snapshot_read(ids, p_ts)):
            assert_same(a, b, f"{name} snapshot_read at the {what}")
    scan = ref_make_batch(ids.reshape(4, 5), np.full((4, 1), -1),
                          np.zeros(4), np.zeros((4, 2)))
    for a, b in zip(ref.run_readonly_batch(scan, r_pin)[:2],
                    port.run_readonly_batch(port_batch(scan), p_pin)[:2]):
        assert_same(a, b, f"{name} run_readonly_batch")
    for a, b in zip(ref.snapshot_windows(ids), port.snapshot_windows(ids)):
        assert_same(a, b, f"{name} snapshot_windows")
    # what the reference's clamp means, on the port's side: an id past
    # the store reads the last row of its shard (one shard: record R-1)
    vals, found = port.snapshot_read(torch.from_numpy(ids), p_pin)
    if "2-shards" not in name:
        pos = {int(x): i for i, x in enumerate(ids)}
        for x in OUTSIDE[:3]:
            assert torch.equal(vals[pos[x]], vals[pos[R - 1]])
            assert found[pos[x]] == found[pos[R - 1]]
        assert found[pos[R - 1]]
