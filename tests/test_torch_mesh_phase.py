"""Phase 17 of ``chip_smoke.py`` on the paged and adaptive-K substrates,
rehearsed on the CPU.

The phase's stream (``chip_smoke.mesh_stream``: batches of zipfian
10-RMW transactions, a pin, a pinned ``snapshot_read``, a ``gc_sweep``;
with adaptive K the pin's release and three batches each ending in a
sweep) runs on ``BohmEngine(mesh=)`` over 4 thread ranks
(``chip_smoke.thread_ranks``) with the paged path's storage settings and
with the adaptive-K settings of ``tests/test_torch_mesh_engine.py``
(``chip_smoke.mesh_substrates``, scaled to 4,096 records and batches of
256), and on the logical 4-shard engine. The two must be byte-equal
(reads, found flags, pinned values, ``k_by_record``, storage and spill
stats, engine counters, every store array with the page table), every
rank must hold row 3 (``mvcc_resolve_paged``, its page table read in
place) and row 2 against their plain versions on its own shard, and the
policy must have granted slots to every rank's records. Launch counts
are the card's part (``mesh_checks(on_card=True)``): a CPU call counts
none.
"""
import functools

import pytest

import chip_smoke as cs

R, T, N = 4096, 256, 4


@pytest.mark.parametrize("what", ["paged", "adaptive"])
def test_phase17_stream_on_the_paged_and_adaptive_mesh(what):
    kw = cs.mesh_substrates(N, R)[what]
    assert kw["paged"] and kw["adaptive_k"]
    got = cs.thread_ranks(functools.partial(
        cs.mesh_stream, n=N, device="cpu", R=R, kw=kw, T=T), N,
        device="cpu")[0]
    per = cs.mesh_checks(got, kw, what, on_card=False)
    assert [x["held"] for x in per] == [3] * N
    assert all(x["granted"] > 0 for x in per)
    assert len(got["gc"]) == 1 + cs.MESH_POLICY_BATCHES
    want = cs.mesh_stream(None, N, "cpu", R=R, kw=kw, T=T)
    cs._same_mesh_run(want, got, what)
    assert "page_table" in " ".join(want["store"])
    assert want["stats"]["counters"]["engine/k_slots_granted"] > 0
    assert want["stats"]["storage"]["alloc_failed"] == 0


def test_mesh_substrates_scale_to_the_records():
    """At 1M records the paged settings are the paged path's own (phase
    6: 2M pages of 2 slots a shard); the adaptive-K settings keep the
    mesh test's 4 pages and one 16-slot spill bucket a record of a
    shard."""
    sub = cs.mesh_substrates(4)
    assert sub["dense"] == {} and sub["paged"] == cs.PAGED
    assert sub["adaptive"] == dict(
        ring_slots=4, adaptive_k=True, k_max=8, paged=True, page_slots=2,
        pages_per_shard=1_000_000, spill_buckets=250_000, spill_slots=16)
