"""The four baseline protocols: the port's ``repro_torch.core.baselines``
(``device="cpu"``) against the JAX reference's runners — the seeded
goldens of ``tests/test_baselines.py`` (exact round, abort, wait and
read-counter counts, base and read sums), its stats contract and abort
accounting, and byte equality of ``(base, reads, stats)`` with the
reference on the same seeded batches at (R, T, theta, mix) in
{(512, 64, 0.9, 10rmw), (256, 48, 0.95, 10rmw), (64, 64, 0.9, 2rmw8r)}.
Every stat keeps the reference's dtype (0-d int32 counts, a [T] bool
commit mask). The MVSG ``certify`` cases wait for the arena.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, np_, port_batch
from repro.core import baselines as ref_bl
from repro.core.txn import make_batch as ref_make_batch
from repro.core.workloads import gen_ycsb_batch, make_ycsb as ref_make_ycsb
from repro_torch.core.baselines import run_2pl, run_hekaton, run_occ, run_si
from repro_torch.core.workloads import make_ycsb
from repro_torch.obs import MetricsRegistry

RUNNERS = {"2pl": run_2pl, "occ": run_occ, "si": run_si,
           "hekaton": run_hekaton}
REF_RUNNERS = {"2pl": ref_bl.run_2pl, "occ": ref_bl.run_occ,
               "si": ref_bl.run_si, "hekaton": ref_bl.run_hekaton}
R, T = 512, 64
CASES = [(512, 64, 0.9, "10rmw"), (256, 48, 0.95, "10rmw"),
         (64, 64, 0.9, "2rmw8r")]
_REF_JITS = {}

GOLDEN = {
    "2pl": {"rounds": 56, "lock_waits": 1798, "aborts": 0,
            "commits": 64},
    "occ": {"rounds": 56, "aborts": 1798, "commits": 64},
    "si": {"rounds": 4, "aborts": 60, "commits": 4},
    "hekaton": {"rounds": 56, "read_counter_bumps": 19260,
                "max_read_crowd": 44, "aborts": 0, "commits": 64},
}
GOLDEN_SUMS = {"2pl": (640, 2653), "occ": (640, 2653),
               "si": (40, 0), "hekaton": (640, 2653)}


def _batch(seed, n_rec, n_txn, theta, mix):
    return gen_ycsb_batch(np.random.default_rng(seed), n_txn, n_rec,
                          theta=theta, mix=mix)


def _golden_batch():
    return _batch(42, R, T, 0.9, "10rmw")


def _run(name, batch, n_rec=R, payload_words=2):
    """The port's runner on the CPU, from a zero store."""
    return RUNNERS[name](torch.zeros((n_rec, payload_words),
                                     dtype=torch.int32),
                         port_batch(batch), make_ycsb(payload_words),
                         n_rec)


def _run_ref(name, batch, n_rec, payload_words=2):
    """The reference's runner (jitted once per configuration)."""
    key = (name, n_rec, payload_words)
    if key not in _REF_JITS:
        _REF_JITS[key] = jax.jit(functools.partial(
            REF_RUNNERS[name], workload=ref_make_ycsb(payload_words),
            num_records=n_rec))
    return _REF_JITS[key](jnp.zeros((n_rec, payload_words), jnp.int32),
                          batch)


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_seeded_golden(name):
    base, reads, m = _run(name, _golden_batch())
    for key, want in GOLDEN[name].items():
        assert int(m[key]) == want, (key, int(m[key]))
    want_base, want_reads = GOLDEN_SUMS[name]
    assert int(base.sum()) == want_base
    assert int(reads.sum()) == want_reads
    # a pure function of (base, batch): a rerun is byte-identical
    b2, r2, m2 = _run(name, _golden_batch())
    assert torch.equal(base, b2) and torch.equal(reads, r2)
    assert all(torch.equal(m[k], m2[k]) for k in m)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_equals_reference(name, case):
    """(base, reads, stats) byte-equal to the reference's runner, every
    stat at the reference's dtype and shape."""
    n_rec, n_txn, theta, mix = case
    batch = _batch(7, n_rec, n_txn, theta, mix)
    ref = _run_ref(name, batch, n_rec)
    got = _run(name, batch, n_rec)
    assert_same(ref[0], got[0], f"{name}: base")
    assert_same(ref[1], got[1], f"{name}: reads")
    assert set(ref[2]) == set(got[2])
    for k, v in ref[2].items():
        a, b = np_(v), np_(got[2][k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_stats_contract(name):
    _, _, m = _run(name, _golden_batch())
    for key in ("rounds", "aborts", "commits"):
        assert m[key].shape == () and m[key].dtype == torch.int32, key
    assert m["commit_mask"].shape == (T,)
    assert m["commit_mask"].dtype == torch.bool
    assert int(m["commit_mask"].sum()) == int(m["commits"])
    reg = MetricsRegistry()
    for k, v in m.items():
        if v.dim() == 0:
            reg.accumulate(f"arena/{name}/{k}", v)
            reg.accumulate(f"arena/{name}/{k}", v)
    snap = reg.snapshot(include_gauges=False)
    assert snap[f"arena/{name}/rounds"] == 2 * int(m["rounds"])


def test_abort_accounting():
    """SI aborts are permanent (commits + aborts = T, one committed
    writer per record); OCC aborts are retries (everyone commits);
    2PL/Hekaton never abort."""
    batch = _golden_batch()
    _, _, ms = _run("si", batch)
    assert int(ms["commits"]) + int(ms["aborts"]) == T
    ws = np_(batch.write_set)
    written = ws[np_(ms["commit_mask"])].ravel()
    written = written[written >= 0]
    assert len(written) == len(set(written.tolist()))
    _, _, mo = _run("occ", batch)
    assert bool(mo["commit_mask"].all()) and int(mo["aborts"]) >= 0
    for name in ("2pl", "hekaton"):
        _, _, m = _run(name, batch)
        assert int(m["aborts"]) == 0 and bool(m["commit_mask"].all())


def test_repeated_writes_take_the_last_column():
    """A transaction that names one record twice: the later write column
    wins, as in the reference's serial scatter."""
    batch = _golden_batch()
    ws = np_(batch.write_set).copy()
    ws[:, 1] = ws[:, 0]                  # columns 0 and 1 write one record
    rs = np_(batch.read_set)
    dup = ref_make_batch(rs, ws, np_(batch.txn_type), np_(batch.args))
    for name in sorted(RUNNERS):
        ref = _run_ref(name, dup, R)
        got = _run(name, dup)
        assert_same(ref[0], got[0], f"{name}: base")
        assert_same(ref[1], got[1], f"{name}: reads")
