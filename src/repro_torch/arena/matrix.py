"""The arena: every protocol over the full workload matrix, one runner
(port of ``repro.arena.matrix``).

A matrix cell is a reproducible batch stream (generator seeded per cell)
drawn from the paper's experiment space — YCSB uniform/zipfian at swept
theta, SmallBank, disjoint/mixed update streams, pinned snapshot scans —
at MATCHED batch sizes across protocols. For each (cell, protocol) the
runner produces one row:

  throughput   committed txn/s over the streamed batches (best of
               ``iters`` timed passes after an untimed warm-up pass);
               GOODPUT — SI's permanently aborted txns don't count;
  abort rate   protocol-native accounting (OCC validation failures, SI
               first-committer-wins losers; 0 by construction for Bohm,
               2PL, Hekaton);
  verdict      ``serial-equivalent`` or ``NON-SERIALIZABLE(...)`` from
               the tag-replay MVSG certifier
               (``repro_torch.arena.anomalies``):
               the same batch stream re-run under the tag workload
               through the same protocol adapter, each batch's
               multiversion serialization graph checked for cycles and
               the final committed state cross-checked;
  proxies      the protocol's native cost counters for the cell, via the
               shared ``repro_torch.obs.MetricsRegistry``.

Cells sharing tensor shapes (R, T, Rd, W, D) share one protocol set —
adapters are reset between cells, never rebuilt. A cell's batches are
built on the device the protocols run on (``device=``, default the
card); the certifier reads the replay's tensors back to the host.

``run_gauntlet`` drives the anomaly scenarios through every protocol
(scenarios run tag semantics directly — their meaning is purely
structural) plus the adversarial-interleaving SI interpreter; the paper's
claim lands as data: SI is the only protocol flagged, and only on the
anomaly scenarios.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.arena import anomalies
from repro_torch.arena.anomalies import (Scenario, _host, certify,
                                         default_scenarios,
                                         run_si_schedule, tag_batch)
from repro_torch.arena.protocols import (PROTOCOL_NAMES, BatchOutput,
                                         ProtocolEngine, make_protocols)
from repro_torch.core.txn import TxnBatch, make_batch
from repro_torch.core.workloads import (gen_scan_batch,
                                        gen_smallbank_batch,
                                        gen_ycsb_batch, make_smallbank,
                                        make_ycsb)
from repro_torch.device import DeviceLike
from repro_torch.obs import MetricsRegistry, PhaseTracer, run_metadata

YCSB_OPS = 10
HOT_SET = 64          # mixed-stream hot-set size
HOT_FRAC = 0.25       # fraction of mixed-stream txns hitting the hot set

_NULL_TRACER = PhaseTracer()    # shared disabled tracer (no-op spans)


@dataclasses.dataclass(frozen=True)
class ArenaCell:
    """One workload point: a named, seeded batch stream. ``scans[i]``
    (optional) is a read-only batch interleaved after update batch i —
    the pinned-snapshot scan scenario."""
    name: str
    kind: str                      # ycsb | smallbank | stream | scan
    num_records: int
    batches: Sequence[TxnBatch]
    theta: float = 0.0
    mix: str = "-"
    scans: Sequence[TxnBatch] = ()

    @property
    def total_txns(self) -> int:
        return sum(b.size for b in self.batches)


def _shift(batch: TxnBatch, offset: int,
           device: DeviceLike = None) -> TxnBatch:
    """Shift every valid record id by ``offset`` (stripe placement); the
    ids are read back on the host and the result built on ``device``."""
    rs = _host(batch.read_set)
    ws = _host(batch.write_set)
    return make_batch(np.where(rs >= 0, rs + offset, rs),
                      np.where(ws >= 0, ws + offset, ws),
                      _host(batch.txn_type), _host(batch.args), device=device)


def _mixed_batch(rng: np.random.Generator, n_txns: int,
                 num_records: int, device: DeviceLike = None) -> TxnBatch:
    """Hot/cold update stream: HOT_FRAC of txns do 10RMW inside a
    HOT_SET-record hot set, the rest run uniform over the cold range.
    The halves are drawn on the host and joined on ``device``."""
    n_hot = int(n_txns * HOT_FRAC)
    hot = gen_ycsb_batch(rng, n_hot, HOT_SET, theta=0.0, mix="10rmw",
                         device="cpu")
    cold = _shift(gen_ycsb_batch(rng, n_txns - n_hot,
                                 num_records - HOT_SET,
                                 theta=0.0, mix="10rmw", device="cpu"),
                  HOT_SET, device="cpu")
    return make_batch(
        np.concatenate([_host(hot.read_set), _host(cold.read_set)]),
        np.concatenate([_host(hot.write_set), _host(cold.write_set)]),
        np.concatenate([_host(hot.txn_type), _host(cold.txn_type)]),
        np.concatenate([_host(hot.args), _host(cold.args)]), device=device)


def arena_matrix(quick: bool = False, seed: int = 0,
                 num_records: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 n_batches: Optional[int] = None,
                 device: DeviceLike = None) -> List[ArenaCell]:
    """The full matrix (``--quick`` shrinks sizes, keeps every cell kind
    so CI exercises all paths). All YCSB-shaped cells share (Rd=W=10,
    D); SmallBank cells share (Rd=W=3, D). Every batch lands on
    ``device``."""
    R = num_records or (1 << 16 if quick else 1 << 18)
    T = batch_size or (256 if quick else 1024)
    B = n_batches or (3 if quick else 8)
    rng = np.random.default_rng(seed)
    cells: List[ArenaCell] = []
    dev = dict(device=device)

    thetas = (0.0, 0.9, 0.99) if quick else (0.0, 0.6, 0.9, 0.99)
    for theta in thetas:
        cells.append(ArenaCell(
            f"ycsb-10rmw-z{theta:g}", "ycsb", R,
            [gen_ycsb_batch(rng, T, R, theta=theta, mix="10rmw", **dev)
             for _ in range(B)], theta=theta, mix="10rmw"))
    cells.append(ArenaCell(
        "ycsb-2rmw8r-z0.9", "ycsb", R,
        [gen_ycsb_batch(rng, T, R, theta=0.9, mix="2rmw8r", **dev)
         for _ in range(B)], theta=0.9, mix="2rmw8r"))

    # disjoint stream: batch b's records live in stripe b — zero
    # cross-batch and zero intra-batch-free contention (the embarrassing
    # case every protocol should ace)
    stripe = R // B
    cells.append(ArenaCell(
        "stream-disjoint", "stream", R,
        [_shift(gen_ycsb_batch(rng, T, min(stripe, R - b * stripe),
                               theta=0.0, mix="10rmw", device="cpu"),
                b * stripe, **dev)
         for b in range(B)], mix="10rmw"))
    # mixed stream: a fixed hot set hammered by a fraction of every batch
    cells.append(ArenaCell(
        "stream-mixed", "stream", R,
        [_mixed_batch(rng, T, R, **dev) for _ in range(B)], mix="10rmw"))

    # pinned snapshot scans interleaved with a contended update stream
    cells.append(ArenaCell(
        "scan-pinned-z0.9", "scan", R,
        [gen_ycsb_batch(rng, T, R, theta=0.9, mix="10rmw", **dev)
         for _ in range(B)], theta=0.9, mix="10rmw",
        scans=[gen_scan_batch(rng, T, R, ops=YCSB_OPS, theta=0.9, **dev)
               for _ in range(B)]))

    # SmallBank: 100 customers = the paper's high-contention point
    n_cust = 100
    sb_T = T
    cells.append(ArenaCell(
        "smallbank-high", "smallbank", 2 * n_cust,
        [gen_smallbank_batch(rng, sb_T, n_cust, **dev) for _ in range(B)],
        mix="full"))
    cells.append(ArenaCell(
        "smallbank-readonly", "smallbank", 2 * n_cust,
        [gen_smallbank_batch(rng, sb_T, n_cust, mix=(1.0, 0, 0, 0, 0),
                             **dev)
         for _ in range(B)], mix="balance"))
    return cells


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------
def _workload_for(cell: ArenaCell, payload_words: int):
    if cell.kind == "smallbank":
        return make_smallbank(payload_words)
    return make_ycsb(payload_words, ops=YCSB_OPS)


def _certify(batch, read_tags, mask, final, tag_offset=0, *,
             tracer: Optional[PhaseTracer] = None,
             registry: Optional[MetricsRegistry] = None,
             label: str = ""):
    """``anomalies.certify`` wrapped in the obs plane: an
    ``arena/certify`` tracer span (host work — no fence) plus registry
    timing counters under the ``arena/`` view, so gauntlet / matrix
    certification cost shows up in the obs report next to the engine
    phases."""
    tracer = tracer if tracer is not None else _NULL_TRACER
    t0 = time.perf_counter()
    with tracer.span("arena/certify", txns=int(batch.size),
                     cell=label) as sp:
        v = certify(batch, read_tags, mask, final, tag_offset=tag_offset)
        sp.note(serializable=v.serializable, edges=v.n_edges)
    if registry is not None:
        registry.inc("arena/certify_calls")
        registry.inc("arena/certify_txns", int(batch.size))
        registry.inc("arena/certify_wall_us",
                     int((time.perf_counter() - t0) * 1e6))
    return v


def tag_replay(proto: ProtocolEngine, batches: Sequence[TxnBatch]
               ) -> Tuple[List[int], List[BatchOutput], np.ndarray]:
    """Re-run ``batches`` under the tag workload through a fresh twin of
    ``proto`` on its device: (tag offsets, per-batch outputs, final word-0
    tags [R] on the host) — what ``_certify_stream`` certifies."""
    twin = proto.tag_twin()
    twin.reset()
    offsets = [int(o) for o in np.cumsum([0] + [b.size
                                                for b in batches[:-1]])]
    outs = twin.run_batches([tag_batch(b, off, device=proto.device)
                             for b, off in zip(batches, offsets)])
    return offsets, outs, _host(twin.finish()[:, 0])


def _certify_stream(proto: ProtocolEngine, cell: ArenaCell,
                    tracer: Optional[PhaseTracer] = None,
                    registry: Optional[MetricsRegistry] = None
                    ) -> Dict[str, object]:
    """Tag-replay the cell's update stream through ``proto``'s twin and
    certify every batch's MVSG (final-state check on the last batch)."""
    offsets, outs, final = tag_replay(proto, list(cell.batches))
    committed = 0
    verdict = None
    for i, (batch, off, out) in enumerate(
            zip(cell.batches, offsets, outs)):
        mask = _host(out.commit_mask)
        committed += int(mask.sum())
        v = _certify(batch, _host(out.read_vals[:, :, 0]), mask,
                     final if i == len(outs) - 1 else None,
                     tag_offset=int(off), tracer=tracer,
                     registry=registry, label=cell.name)
        if verdict is None or (verdict.serializable
                               and not v.serializable):
            verdict = v
    return {"committed": committed, "verdict": verdict.label,
            "exact": verdict.exact}


def run_cell(cell: ArenaCell, protos: Dict[str, ProtocolEngine],
             iters: int = 2, base=None,
             tracer: Optional[PhaseTracer] = None,
             registry: Optional[MetricsRegistry] = None
             ) -> List[Dict[str, object]]:
    """One matrix cell across protocols -> one row per protocol.
    ``base`` (optional [R, D]) seeds every protocol's store each stream
    (SmallBank's non-zero opening balances); certification always runs
    on a zero store — tag semantics ignore payloads. The timed window
    ends in each adapter's ``finish`` (a ``device.fence``)."""
    rows = []
    for name, proto in protos.items():
        def stream() -> None:
            proto.reset(base)
            for i, batch in enumerate(cell.batches):
                proto.submit(batch)
                if cell.scans:
                    proto.run_scan(cell.scans[i])
            proto.finish()

        stream()                                   # untimed warm-up pass
        best = np.inf
        for _ in range(iters):
            t0 = time.perf_counter()
            stream()
            best = min(best, time.perf_counter() - t0)
        # reset() zeroes the protocol's own counters, so these are the
        # final timed stream's values — one stream's worth of proxies
        proxies = proto.proxy_stats()

        cert = _certify_stream(proto, cell, tracer=tracer,
                               registry=registry)
        total = cell.total_txns + sum(s.size for s in cell.scans)
        committed = cert["committed"] + sum(s.size for s in cell.scans)
        aborted = cell.total_txns - cert["committed"]
        rows.append({
            "cell": cell.name, "kind": cell.kind, "theta": cell.theta,
            "mix": cell.mix, "protocol": name,
            "num_records": cell.num_records,
            "batch_size": cell.batches[0].size,
            "n_batches": len(cell.batches),
            "txns": total, "committed": committed,
            "time_s": round(best, 6),
            "txn_s": round(committed / best, 1),
            "abort_rate": round(aborted / max(cell.total_txns, 1), 4),
            "verdict": cert["verdict"], "exact": cert["exact"],
            "proxy": " ".join(f"{k}={v}" for k, v in proxies.items()),
        })
    return rows


def run_matrix(cells: Optional[Iterable[ArenaCell]] = None,
               quick: bool = False, iters: int = 2,
               protocols: Sequence[str] = PROTOCOL_NAMES,
               registry: Optional[MetricsRegistry] = None,
               payload_words: int = 2,
               progress: Optional[Callable[[str], None]] = None,
               tracer: Optional[PhaseTracer] = None,
               device: DeviceLike = None
               ) -> List[Dict[str, object]]:
    """All cells x all protocols on ``device``. Protocol sets are built
    once per tensor-shape group and reset between cells."""
    cells = list(cells if cells is not None
                 else arena_matrix(quick, device=device))
    registry = registry if registry is not None else MetricsRegistry()
    groups: Dict[tuple, Dict[str, ProtocolEngine]] = {}
    rows: List[Dict[str, object]] = []
    for cell in cells:
        wl = _workload_for(cell, payload_words)
        key = (cell.kind == "smallbank", cell.num_records,
               wl.payload_words)
        if key not in groups:
            groups[key] = make_protocols(cell.num_records, wl, registry,
                                         names=protocols, device=device)
        if progress:
            progress(f"cell {cell.name}: {len(groups[key])} protocols")
        rows.extend(run_cell(cell, groups[key], iters=iters,
                             tracer=tracer, registry=registry))
    return rows


def stamp_results(rows: List[Dict[str, object]],
                  extra: Optional[Dict[str, object]] = None
                  ) -> Dict[str, object]:
    """Provenance-wrap a matrix / gauntlet row list:
    ``{"meta": run_metadata(), "rows": rows}`` — the same twin shape
    ``benchmarks_torch.common.write_json`` emits, for callers that
    persist arena results directly."""
    return {"meta": run_metadata(extra), "rows": rows}


# ---------------------------------------------------------------------------
# The gauntlet, cross-protocol
# ---------------------------------------------------------------------------
def run_gauntlet(scenarios: Optional[Sequence[Scenario]] = None,
                 protocols: Sequence[str] = PROTOCOL_NAMES,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[PhaseTracer] = None,
                 device: DeviceLike = None
                 ) -> List[Dict[str, object]]:
    """Every anomaly scenario through every protocol adapter on
    ``device`` (on tag semantics — scenario meaning is purely structural)
    plus the ``si-schedule`` interpreter under the scenario's adversarial
    begin/commit interleaving. One row per (scenario, protocol)."""
    scenarios = list(scenarios if scenarios is not None
                     else default_scenarios(device=device))
    registry = registry if registry is not None else MetricsRegistry()
    rows = []
    groups: Dict[tuple, Dict[str, ProtocolEngine]] = {}
    for sc in scenarios:
        Rd, W = sc.batch.n_read, sc.batch.n_write
        key = (sc.n_records, Rd, W)
        if key not in groups:
            wl = anomalies.make_tag_workload(Rd, W)
            groups[key] = make_protocols(sc.n_records, wl, registry,
                                         names=protocols, device=device)
        tagged = None
        for name, proto in groups[key].items():
            if tagged is None:
                tagged = tag_batch(sc.batch, 0, device=proto.device)
            proto.reset()
            out = proto.run_batch(tagged)
            final = _host(proto.finish()[:, 0])
            v = _certify(sc.batch, _host(out.read_vals[:, :, 0]),
                         _host(out.commit_mask), final,
                         tracer=tracer, registry=registry,
                         label=f"gauntlet:{sc.name}")
            rows.append(_gauntlet_row(sc, name, v))
        final, read_tags, mask = run_si_schedule(
            sc.batch, sc.n_records, sc.si_begin, sc.si_commit)
        v = _certify(sc.batch, read_tags, mask, final, tracer=tracer,
                     registry=registry, label=f"gauntlet:{sc.name}")
        rows.append(_gauntlet_row(sc, "si-schedule", v))
    return rows


def _gauntlet_row(sc: Scenario, protocol: str,
                  v: "anomalies.Verdict") -> Dict[str, object]:
    # ground truth: only SI may exhibit an anomaly, and the adversarial
    # si-schedule interpreter must exhibit it whenever the scenario
    # carries one (batch-concurrent ``si`` needs no interleaving for
    # write-skew but cannot express the read-only anomaly)
    if protocol == "si-schedule":
        expected = not sc.expect_si_anomaly
    elif protocol == "si":
        expected = not (sc.expect_si_anomaly
                        and sc.name.startswith("write-skew"))
    else:
        expected = True
    return {"cell": f"gauntlet:{sc.name}", "kind": "gauntlet",
            "theta": 0.0, "mix": "-", "protocol": protocol,
            "num_records": sc.n_records, "batch_size": sc.batch.size,
            "n_batches": 1, "txns": sc.batch.size,
            "committed": v.n_committed, "time_s": 0.0, "txn_s": 0.0,
            "abort_rate": round(1 - v.n_committed
                                / max(sc.batch.size, 1), 4),
            "verdict": v.label, "exact": v.exact,
            "proxy": f"edges={v.n_edges}"
                     + (f" cycle={list(v.cycle)}" if v.cycle else ""),
            "expected_serializable": expected,
            "as_expected": v.serializable == expected}
