"""Batch footprints: the port's ``repro_torch.core.plan`` footprint
functions against the JAX reference's on the same numpy inputs — the
cases of ``tests/test_plan.py``'s footprint section. Bitsets and
signatures must be byte-equal, every conflict verdict and witness equal,
and ``merge_batches`` must concatenate (and reject width mismatches) as
the reference does, with the merged epoch planning like its parts.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, np_, port_batch
from repro.core import plan as ref_plan
from repro.core.txn import make_batch as ref_make_batch
from repro_torch.core import plan as port_plan
from repro_torch.core.txn import make_batch


def _both(reads, writes, R=130):
    """(reference footprint, port footprint, reference batch, port
    batch) of one batch."""
    reads, writes = np.asarray(reads), np.asarray(writes)
    n = len(reads)
    ref_b = ref_make_batch(reads, writes, np.zeros(n), np.zeros((n, 1)))
    port_b = make_batch(reads, writes, np.zeros(n), np.zeros((n, 1)),
                        device="cpu")
    ref_fp = ref_plan.batch_footprint(ref_b, R)
    port_fp = port_plan.batch_footprint(port_b, R)
    _same_fp(ref_fp, port_fp)
    return ref_fp, port_fp, ref_b, port_b


def _same_fp(ref_fp, port_fp):
    for name in ("read_bits", "write_bits", "rw_bits"):
        a, b = getattr(ref_fp, name), getattr(port_fp, name)
        assert a.dtype == b.dtype == np.uint64, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ref_fp.write_sig, ref_fp.rw_sig) == \
        (port_fp.write_sig, port_fp.rw_sig)


def _bits_to_set(bits):
    return {w * 64 + r for w in range(len(bits)) for r in range(64)
            if (int(bits[w]) >> r) & 1}


def test_footprint_bitsets_cover_exactly_the_touched_records():
    # R=130 spans three uint64 words; pads (-1) must not set bits
    _, fp, _, _ = _both([[0, 64], [129, -1]], [[64, -1], [-1, -1]])
    assert _bits_to_set(fp.read_bits) == {0, 64, 129}
    assert _bits_to_set(fp.write_bits) == {64}
    assert _bits_to_set(fp.rw_bits) == {0, 64, 129}
    assert fp.rw_sig == 0b111 and fp.write_sig == 0b10


@pytest.mark.parametrize("pair,conflict", [
    ((([[1]], [[2]]), ([[3]], [[4]])), False),
    ((([[9]], [[5]]), ([[5]], [[6]])), True),     # w of one, r of other
    ((([[5]], [[6]]), ([[9]], [[5]])), True),     # symmetric
    ((([[-1]], [[7]]), ([[-1]], [[7]])), True),   # write-write
    ((([[8]], [[1]]), ([[8]], [[2]])), False),    # read-read sharing
])
def test_footprints_conflict_directions(pair, conflict):
    ra, pa, _, _ = _both(*pair[0])
    rb, pb, _, _ = _both(*pair[1])
    assert port_plan.footprints_conflict(pa, pb) is conflict
    assert ref_plan.footprints_conflict(ra, rb) is conflict
    assert port_plan.conflict_witness(pa, pb) == \
        ref_plan.conflict_witness(ra, rb)


def test_footprint_signatures_certify_disjointness():
    """Disjoint signatures certify disjoint footprints; colliding
    signatures of disjoint sets fall back to the word scan; merged
    signatures are the OR of the members'."""
    _, a, _, _ = _both([[2]], [[2]])
    _, b, _, _ = _both([[66]], [[66]])
    assert port_plan.signatures_disjoint(a, b)
    assert not port_plan.footprints_conflict(a, b)
    _, c, _, _ = _both([[3]], [[3]])
    assert not port_plan.signatures_disjoint(a, c)
    assert not port_plan.footprints_conflict(a, c)
    _, d, _, _ = _both([[2]], [[-1]])
    assert not port_plan.signatures_disjoint(a, d)
    assert port_plan.footprints_conflict(a, d)
    ra, _, _, _ = _both([[2]], [[2]])
    rc, _, _, _ = _both([[3]], [[3]])
    fm = port_plan.merge_footprints(a, c)
    _same_fp(ref_plan.merge_footprints(ra, rc), fm)
    assert fm.rw_sig == a.rw_sig | c.rw_sig
    assert fm.write_sig == a.write_sig | c.write_sig


def test_footprint_randomized_agreement_and_witnesses():
    """On random batches: equal bitsets and signatures, the signature
    fast path never flips a verdict, and every pair's verdict and
    witness equal the reference's; a witness is a record written by one
    side and touched by the other."""
    rng = np.random.default_rng(42)
    pairs = []
    for _ in range(24):
        reads = rng.integers(-1, 320, (4, 3))
        writes = np.where(rng.random((4, 3)) < 0.5, reads, -1)
        ref_fp, port_fp, _, _ = _both(reads, writes, R=320)
        pairs.append((ref_fp, port_fp))

    def has(bits, rec):
        return bool(int(bits[rec >> 6]) >> (rec & 63) & 1)

    conflicts = 0
    for ra, pa in pairs:
        for rb, pb in pairs:
            slow = bool(np.any(pa.write_bits & pb.rw_bits)
                        or np.any(pb.write_bits & pa.rw_bits))
            assert port_plan.footprints_conflict(pa, pb) == slow \
                == ref_plan.footprints_conflict(ra, rb)
            if port_plan.signatures_disjoint(pa, pb):
                assert not slow
            w = port_plan.conflict_witness(pa, pb)
            assert w == ref_plan.conflict_witness(ra, rb)
            if slow:
                assert (has(pa.write_bits, w) and has(pb.rw_bits, w)) or \
                    (has(pb.write_bits, w) and has(pa.rw_bits, w))
                conflicts += 1
            else:
                assert w is None
    assert conflicts > 10


def test_merge_batches_preserves_order_and_timestamps():
    """The merged batch equals the reference's merge, and cc_plan over it
    assigns every txn the global begin/end ts of the two per-batch plans
    at consecutive ts bases."""
    ra1, pa1, rb1, pb1 = _both([[3, 4]], [[3, -1]])
    ra2, pa2, rb2, pb2 = _both([[10, 11]], [[10, 11]])
    assert not port_plan.footprints_conflict(pa1, pa2)
    merged = port_plan.merge_batches(pb1, pb2)
    ref_merged = ref_plan.merge_batches(rb1, rb2)
    for f in ("read_set", "write_set", "txn_type", "args"):
        assert_same(getattr(ref_merged, f), getattr(merged, f), f)
        assert getattr(merged, f).dtype == torch.int32
    assert merged.size == 2
    _same_fp(ref_plan.merge_footprints(ra1, ra2),
             port_plan.merge_footprints(pa1, pa2))
    pm = port_plan.cc_plan(merged, 5)
    p1 = port_plan.cc_plan(pb1, 5)
    p2 = port_plan.cc_plan(pb2, 6)

    def rows(p):
        v = np_(p.w_valid).astype(bool)
        out = np.stack([np_(p.w_rec)[v], np_(p.w_begin_ts)[v],
                        np_(p.w_end_ts)[v], np_(p.commit_mask)[v]], axis=1)
        return out[np.lexsort(out.T[::-1])]

    both = np.concatenate([rows(p1), rows(p2)])
    np.testing.assert_array_equal(rows(pm), both[np.lexsort(both.T[::-1])])
    np.testing.assert_array_equal(np_(pm.r_dep_txn)[1], np_(p2.r_dep_txn)[0])
    ref_pm = ref_plan.cc_plan(ref_merged, np.int32(5))
    for f in ("w_rec", "w_begin_ts", "w_end_ts", "commit_mask", "r_dep_txn",
              "r_dep_slot"):
        assert_same(getattr(ref_pm, f), getattr(pm, f), f)


def test_merge_batches_rejects_width_mismatch():
    def pair(make, **kw):
        a = make(np.zeros((1, 2)), np.zeros((1, 2)), np.zeros(1),
                 np.zeros((1, 1)), **kw)
        b = make(np.zeros((1, 3)), np.zeros((1, 3)), np.zeros(1),
                 np.zeros((1, 1)), **kw)
        return a, b

    with pytest.raises(ValueError) as ref_err:
        ref_plan.merge_batches(*pair(ref_make_batch))
    with pytest.raises(ValueError) as port_err:
        port_plan.merge_batches(*pair(make_batch, device="cpu"))
    assert str(port_err.value) == str(ref_err.value)


def test_merge_batches_on_the_batches_device():
    """A merged epoch lies where its batches lie (the CPU here)."""
    _, _, rb, pb = _both([[1, 2]], [[1, -1]])
    merged = port_plan.merge_batches(pb, port_batch(rb))
    assert merged.read_set.device == pb.read_set.device
    assert merged.size == 2
