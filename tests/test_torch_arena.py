"""Protocol arena parity: the port's ``repro_torch.arena`` (``device=
"cpu"``) against the JAX reference's ``repro.arena`` on the same numpy
inputs.

All integer results are byte-equal: the certifier's ``Verdict`` (the
hand-built histories of ``tests/test_arena.py`` and seeded random ones),
the SI schedule interpreter (adversarial and degenerate; the degenerate
schedule also equals the port's batch-concurrent ``run_si``), the
standing scenarios for seeds 0-2, the tag instrumentation, every
adapter's ``run_batches`` / ``finish`` / ``proxy_stats`` on the zipfian
stream of ``test_arena.py`` and Bohm's pinned ``run_scan``, the gauntlet's
rows, ``arena_matrix``'s cells, and ``run_cell``'s rows on small cells in
every field but the two wall-clock ones (``time_s``, ``txn_s``). The
reference's rows come from ``iters=0`` (its compile pass and its
certification only), the port's from one timed pass. Shapes are small
and the reference's protocol sets are built once per module, so its
jitted programs compile once per shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BATCH_FIELDS, assert_same, np_, port_batch
from repro import arena as ref
from repro.core import workloads as ref_wl
from repro.core.txn import make_batch as ref_make_batch
from repro_torch import arena
from repro_torch.core import workloads as port_wl
from repro_torch.core.baselines import run_si
from repro_torch.core.txn import make_batch
from repro_torch.obs import MetricsRegistry

CPU = dict(device="cpu")
TIMING = ("time_s", "txn_s")
# test_arena.py's zipfian stream (test_protocol_certified_on_zipfian_stream)
R_Z, T_Z, B_Z, THETA_Z = 256, 48, 3, 0.95
# the small matrix both sides build for run_cell
MATRIX = dict(num_records=512, batch_size=32, n_batches=2, seed=0)
CELLS = ("ycsb-10rmw-z0.9", "stream-mixed", "scan-pinned-z0.9",
         "smallbank-high")


def _same_batch(a, b, msg=""):
    for f in BATCH_FIELDS:
        assert_same(getattr(a, f), getattr(b, f), f"{msg}: {f}")


def _both_batches(reads, writes, types, args):
    arrays = [np.asarray(x, np.int64) for x in (reads, writes, types, args)]
    return ref_make_batch(*arrays), make_batch(*arrays, **CPU)


def _without_timing(row):
    return {k: v for k, v in row.items() if k not in TIMING}


# ---------------------------------------------------------------------------
# The certifier
# ---------------------------------------------------------------------------
# (reads, writes, read_tags, commit_mask, final_tags, tag_offset): the
# lost update, dirty read, final-state mismatch and serial chain of
# tests/test_arena.py
HAND_BUILT = {
    "lost-update": ([[0], [0]], [[0], [0]], [[0], [0]], [1, 1], [2], 0),
    "dirty-read": ([[0], [0]], [[0], [0]], [[0], [1]], [0, 1], None, 0),
    "final-state": ([[0]], [[0]], [[0]], [1], [7], 0),
    "serial-chain": ([[0]] * 3, [[0]] * 3, [[0], [1], [2]], [1, 1, 1], [3],
                     0),
    "offset-chain": ([[0]] * 3, [[0]] * 3, [[5], [6], [7]], [1, 1, 1], [8],
                     5),
}


def _certify_both(reads, writes, tags, mask, final, offset=0):
    T = len(reads)
    rb, pb = _both_batches(reads, writes, np.zeros(T), np.zeros((T, 1)))
    tags = np.asarray(tags, np.int64)
    mask = np.asarray(mask, bool)
    final = None if final is None else np.asarray(final, np.int64)
    want = ref.certify(rb, tags, mask, final, tag_offset=offset)
    # the port reads tensors as well as arrays
    got = arena.certify(pb, torch.from_numpy(tags), torch.from_numpy(mask),
                        None if final is None else torch.from_numpy(final),
                        tag_offset=offset)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.label == want.label
    return got


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_certify_hand_built_histories(case):
    v = _certify_both(*HAND_BUILT[case])
    expect = {"lost-update": (False, "cycle"),
              "dirty-read": (False, "dirty-read"),
              "final-state": (False, "final-state"),
              "serial-chain": (True, ""), "offset-chain": (True, "")}
    assert (v.serializable, v.reason) == expect[case]


@pytest.mark.parametrize("seed", range(6))
def test_certify_seeded_random_histories(seed):
    """Random read/write sets, observed tags, commit masks and final
    states: dirty reads, phantom versions, broken chains, cycles and
    serializable histories alike give equal verdicts."""
    rng = np.random.default_rng(seed)
    labels = set()
    for _ in range(40):
        T, R, width = int(rng.integers(2, 10)), int(rng.integers(2, 8)), 2
        reads = rng.integers(-1, R, (T, width))
        writes = np.where(rng.random((T, width)) < 0.6, reads, -1)
        offset = int(rng.integers(0, 3))
        tags = rng.integers(0, T + 1, (T, width)) + offset
        mask = rng.random(T) < 0.8
        final = rng.integers(0, T + 1, R) + offset \
            if rng.random() < 0.5 else None
        labels.add(_certify_both(reads, writes, tags, mask, final,
                                 offset).label)
    assert len(labels) >= 2, labels


# ---------------------------------------------------------------------------
# The SI schedule interpreter
# ---------------------------------------------------------------------------
def _scenario_pair(kind, *args):
    maker = {"ws": "write_skew_scenario", "ro": "read_only_anomaly_scenario",
             "rmw": "rmw_control_scenario"}[kind]
    return getattr(ref, maker)(*args), getattr(arena, maker)(*args, **CPU)


@pytest.mark.parametrize("kind,args", [("ws", (1, 0)), ("ws", (3, 2, 1)),
                                       ("ro", (1,)), ("ro", (3, 2)),
                                       ("rmw", (8, 4)), ("rmw", (12, 3, 2))])
def test_si_schedule_adversarial(kind, args):
    rs, ps = _scenario_pair(kind, *args)
    want = ref.run_si_schedule(rs.batch, rs.n_records, rs.si_begin,
                               rs.si_commit)
    got = arena.run_si_schedule(ps.batch, ps.n_records, ps.si_begin,
                                ps.si_commit)
    for a, b in zip(want, got):
        assert_same(a, b, f"{kind}{args}")
    v_ref = ref.certify(rs.batch, want[1], want[2], want[0])
    v = arena.certify(ps.batch, got[1], got[2], got[0])
    assert dataclasses.asdict(v) == dataclasses.asdict(v_ref)
    assert v.serializable == (not ps.expect_si_anomaly)


def test_si_schedule_rejects_commit_before_begin():
    sc = arena.write_skew_scenario(1, 0, **CPU)
    with pytest.raises(ValueError):
        arena.run_si_schedule(sc.batch, sc.n_records, [0, 0], [0, 1])


@pytest.mark.parametrize("seed,theta", [(0, 0.0), (1, 0.9), (2, 0.99)])
def test_si_schedule_degenerate_equals_run_si(seed, theta):
    """All begin at 0 and commit at 1: the interpreter equals the
    reference's interpreter and the port's batch-concurrent ``run_si``
    on the tag workload."""
    R, T = 128, 32
    batch = ref_wl.gen_ycsb_batch(np.random.default_rng(seed), T, R,
                                  theta=theta, mix="10rmw")
    pb = port_batch(batch)
    want = ref.run_si_schedule(batch, R, [0] * T, [1] * T)
    got = arena.run_si_schedule(pb, R, [0] * T, [1] * T)
    for a, b in zip(want, got):
        assert_same(a, b, "degenerate schedule")
    wl = arena.make_tag_workload(batch.n_read, batch.n_write)
    final, vals, m = run_si(torch.zeros((R, 1), dtype=torch.int32),
                            arena.tag_batch(pb, 0, **CPU), wl, R)
    assert_same(m["commit_mask"], got[2], "run_si commit mask")
    assert_same(final[:, 0].to(torch.int64), got[0], "run_si final")
    assert_same(vals[:, :, 0].to(torch.int64), got[1], "run_si reads")


# ---------------------------------------------------------------------------
# Scenarios and tag instrumentation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_default_scenarios_equal(seed):
    want, got = ref.default_scenarios(seed), arena.default_scenarios(seed,
                                                                      **CPU)
    assert [s.name for s in got] == [s.name for s in want]
    for a, b in zip(want, got):
        assert (a.n_records, a.expect_si_anomaly) == (b.n_records,
                                                      b.expect_si_anomaly)
        _same_batch(a.batch, b.batch, a.name)
        assert_same(a.si_begin, b.si_begin, a.name)
        assert_same(a.si_commit, b.si_commit, a.name)


@pytest.mark.parametrize("offset", [0, 7, 1000])
def test_tag_batch_and_workload_equal(offset):
    batch = ref_wl.gen_ycsb_batch(np.random.default_rng(3), 24, 64,
                                  theta=0.9, mix="2rmw8r")
    want = ref.tag_batch(batch, offset)
    got = arena.tag_batch(port_batch(batch), offset, **CPU)
    _same_batch(want, got, "tag_batch")
    assert got.args.dtype == torch.int32
    # the branch: word 0 of every write slot carries the tag
    for D in (1, 3):
        rwl = ref.make_tag_workload(10, 10, D)
        pwl = arena.make_tag_workload(10, 10, D)
        assert (pwl.n_read, pwl.n_write, pwl.payload_words) == (
            rwl.n_read, rwl.n_write, rwl.payload_words)
        vals = np.random.default_rng(offset).integers(
            -9, 9, (24, 10, D)).astype(np.int32)
        w_ref, a_ref = jax.vmap(rwl.branches[0])(jnp.asarray(vals),
                                                 want.args)
        w, a = pwl.apply(got.txn_type, torch.from_numpy(vals), got.args)
        assert_same(w_ref, w, "tag writes")
        assert_same(a_ref, a, "tag aborts")


# ---------------------------------------------------------------------------
# The adapters
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def zipf_stream():
    rng = np.random.default_rng(5)
    return [ref_wl.gen_ycsb_batch(rng, T_Z, R_Z, theta=THETA_Z, mix="10rmw")
            for _ in range(B_Z)]


@pytest.mark.parametrize("name", arena.PROTOCOL_NAMES)
def test_adapter_run_batches_equal(name, zipf_stream):
    """``run_batches`` of the tag-instrumented stream, ``finish`` and
    ``proxy_stats`` equal the reference adapter's; every batch certifies
    serial-equivalent and exact (SI too: pure RMW). Bohm's pinned
    zero-bookkeeping ``run_scan`` then reads what the reference's does,
    at the end of the stream and after one more batch."""
    rp = ref.make_protocol(name, R_Z, ref.make_tag_workload(10, 10))
    pp = arena.make_protocol(name, R_Z, arena.make_tag_workload(10, 10),
                             **CPU)
    assert (pp.name, pp.proxy_keys) == (rp.name, rp.proxy_keys)
    r_outs = rp.run_batches([ref.tag_batch(b, i * T_Z)
                             for i, b in enumerate(zipf_stream)])
    p_outs = pp.run_batches([arena.tag_batch(port_batch(b), i * T_Z, **CPU)
                             for i, b in enumerate(zipf_stream)])
    r_final, p_final = rp.finish(), pp.finish()
    assert_same(r_final, p_final, f"{name}: finish")
    for i, (a, b) in enumerate(zip(r_outs, p_outs)):
        assert_same(a.read_vals, b.read_vals, f"{name}: batch {i} reads")
        assert_same(a.commit_mask, b.commit_mask, f"{name}: batch {i} mask")
        v = arena.certify(port_batch(zipf_stream[i]),
                          b.read_vals[:, :, 0], b.commit_mask,
                          p_final[:, 0] if i == B_Z - 1 else None,
                          tag_offset=i * T_Z)
        assert v.serializable and v.exact, (name, i, v)
    assert list(pp.proxy_stats().items()) == list(rp.proxy_stats().items())
    if not name.startswith("bohm"):
        return
    rng = np.random.default_rng(6)
    for extra in (None, zipf_stream[0]):
        if extra is not None:
            rp.submit(ref.tag_batch(extra, B_Z * T_Z))
            pp.submit(arena.tag_batch(port_batch(extra), B_Z * T_Z, **CPU))
        scan = ref_wl.gen_scan_batch(rng, T_Z, R_Z, ops=10, theta=0.9)
        assert_same(rp.run_scan(scan), pp.run_scan(port_batch(scan)),
                    f"{name}: scan")


def test_tag_twin_commit_equivalence():
    """Commit decisions depend only on read/write sets (SI, the one
    protocol with data-independent aborts); the twin keeps the device."""
    batch = port_wl.gen_ycsb_batch(np.random.default_rng(9), 32, 128,
                                   theta=0.9, mix="10rmw", **CPU)
    real = arena.make_protocol("si", 128, port_wl.make_ycsb(2), **CPU)
    twin = real.tag_twin()
    assert twin.device == real.device
    m_real = real.run_batch(batch).commit_mask
    m_twin = twin.run_batch(arena.tag_batch(batch, 0, **CPU)).commit_mask
    assert torch.equal(m_real, m_twin)


# ---------------------------------------------------------------------------
# The gauntlet and the matrix runner
# ---------------------------------------------------------------------------
def test_gauntlet_rows_equal():
    """test_arena.py:127's scenario set: equal rows, every one as
    expected, SI flagged exactly on write-skew (and the schedule
    interpreter on the read-only anomaly too)."""
    args = [("ws", (2, 2)), ("ro", (1,)), ("rmw", (8, 4))]
    pairs = [_scenario_pair(k, *a) for k, a in args]
    want = ref.run_gauntlet([r for r, _ in pairs])
    got = arena.run_gauntlet([p for _, p in pairs], **CPU)
    assert got == want
    assert [list(r) for r in got] == [list(r) for r in want]
    assert all(r["as_expected"] for r in got)
    assert {(r["cell"], r["protocol"]) for r in got
            if r["verdict"] != "serial-equivalent"} == {
        ("gauntlet:write-skew(p2,n2,s0)", "si"),
        ("gauntlet:write-skew(p2,n2,s0)", "si-schedule"),
        ("gauntlet:read-only-anomaly(t1,s0)", "si-schedule")}


@pytest.fixture(scope="module")
def matrices():
    return ({c.name: c for c in ref.arena_matrix(**MATRIX)},
            {c.name: c for c in arena.arena_matrix(**MATRIX, **CPU)})


def test_arena_matrix_equal(matrices):
    want, got = matrices
    assert list(got) == list(want)
    for name, a in want.items():
        b = got[name]
        for f in ("name", "kind", "num_records", "theta", "mix"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert (len(a.batches), len(a.scans)) == (len(b.batches),
                                                  len(b.scans))
        for x, y in zip([*a.batches, *a.scans], [*b.batches, *b.scans]):
            _same_batch(x, y, name)
        assert a.total_txns == b.total_txns


@pytest.fixture(scope="module")
def ref_protocol_sets():
    """One reference protocol set per shape group, shared by the cells
    (as ``run_matrix`` shares them), and one tag twin per protocol and
    shape: ``_certify_stream`` resets the twin before its replay, so a
    reused twin replays exactly as a fresh one, and each jitted program
    compiles once."""
    twins = {}

    def cached(make):
        def tag_twin(self):
            key = (self.name, self.num_records, self.workload.n_read)
            if key not in twins:
                twins[key] = make(self)
            return twins[key]
        return tag_twin

    with pytest.MonkeyPatch.context() as mp:
        for cls in (ref.BohmProtocol, ref.BaselineProtocol):
            mp.setattr(cls, "tag_twin", cached(cls.tag_twin))
        yield {"ycsb": ref.make_protocols(512, ref_wl.make_ycsb(2, ops=10)),
               "smallbank": ref.make_protocols(200,
                                               ref_wl.make_smallbank(2))}


@pytest.mark.parametrize("cell", CELLS)
def test_run_cell_rows_equal(cell, matrices, ref_protocol_sets):
    """Every field but the wall-clock ones, in the reference's key order;
    SmallBank opens every account at 1000."""
    rc, pc = matrices[0][cell], matrices[1][cell]
    kind = "smallbank" if rc.kind == "smallbank" else "ycsb"
    base = (np.full((rc.num_records, 2), 1000, np.int32)
            if kind == "smallbank" else None)
    want = ref.run_cell(rc, ref_protocol_sets[kind], iters=0,
                        base=None if base is None else jnp.asarray(base))
    wl = port_wl.make_smallbank(2) if kind == "smallbank" \
        else port_wl.make_ycsb(2, ops=10)
    registry = MetricsRegistry()
    protos = arena.make_protocols(pc.num_records, wl, registry, **CPU)
    got = arena.run_cell(pc, protos, iters=1, base=base, registry=registry)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [_without_timing(r) for r in got] == \
        [_without_timing(r) for r in want]
    assert all(r["verdict"] == "serial-equivalent" and r["time_s"] > 0
               for r in got)
    assert registry.get("arena/certify_calls") == 6 * len(pc.batches)


def test_stamp_results_meta_names_no_jax():
    out = arena.stamp_results([{"a": 1}], {"quick": True})
    assert out["rows"] == [{"a": 1}]
    meta = out["meta"]
    assert not any("jax" in k for k in meta), meta
    for key in ("torch_version", "cuda_version", "backend", "device_count",
                "device_name", "python_version", "platform", "git_sha",
                "timestamp"):
        assert key in meta
    assert meta["quick"] is True
    assert meta["backend"] in ("cuda", "cpu")


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = port_wl.make_ycsb(2)
    batch = make_batch([[0]], [[0]], [0], [[0]], **CPU)
    for call in (lambda: arena.make_protocol("bohm", 16, wl),
                 lambda: arena.make_protocol("2pl", 16, wl),
                 lambda: arena.make_protocols(16, wl),
                 lambda: arena.arena_matrix(True, num_records=64,
                                            batch_size=8, n_batches=1),
                 lambda: arena.default_scenarios(),
                 lambda: arena.write_skew_scenario(1),
                 lambda: arena.tag_batch(batch, 0),
                 lambda: arena.run_gauntlet()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert arena.make_protocol("occ", 16, wl, **CPU).device.type == "cpu"
