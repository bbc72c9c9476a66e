"""Anomaly gauntlet (port of ``repro.arena.anomalies``): an
output-driven serializability certifier plus the concrete scenarios that
separate Snapshot Isolation from serializable execution (*A Critique of
Snapshot Isolation*, arXiv 2405.18393).

The certifier never inspects protocol internals. A protocol run is
**instrumented** instead: the batch is re-run under a *tag workload* whose
transaction ``t`` blind-writes the unique value ``offset + t + 1`` into
word 0 of every record it writes (the initial version is tag 0, i.e. any
value at or below ``offset``). Every commit / abort / ordering decision in
this codebase's protocol models depends only on the read/write SETS, never
on payload values, so the tag run observes exactly the version-visibility
structure of the real run — and tags make that structure legible: a read
value identifies precisely which transaction's version was observed.

From the observed reads the checker builds the multiversion serialization
graph (MVSG) over committed transactions:

  wr  the observed version's writer precedes its reader;
  ww  consecutive writers in each record's version order;
  rw  a reader of version ``v`` precedes the writer of ``v``'s successor
      (the anti-dependency edge — the one SI does not track).

The record version order is *inferred from the reads themselves*: when
every committed writer of a record also reads it (RMW — true of every
workload in the matrix), each writer's observed read names its predecessor
version, chaining the writers into a total order whose tail must match the
final state. The execution is serial-equivalent iff the MVSG is acyclic
(Bernstein & Goodman); a broken chain (e.g. two writers that both read the
same version — a lost update) falls back to timestamp order for the ww
edges and is marked ``exact=False``, but in every such case the rw edges
already exhibit the cycle.

Scenario generators are parameterized (pair/triple count, noise
transactions, seeds) so the gauntlet doubles as a scenario-diversity
benchmark; ``run_si_schedule`` is the adversarial-interleaving SI
interpreter that the read-only anomaly needs (a txn whose snapshot is
older than a commit that a later read-only txn observes), with the
batch-concurrent ``run_si`` baseline as the degenerate all-begin-at-zero
case.

The certifier and the SI interpreter are host numpy, as in the
reference: they read a batch's tensors through ``.cpu().numpy()``. Every
function that builds a ``TxnBatch`` takes ``device=`` and, like every
entry point of the port, defaults to the card (``repro_torch.device``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.txn import TxnBatch, Workload, make_batch
from repro_torch.device import DeviceLike

INIT = -1                     # virtual "initial version" writer


def _host(x) -> np.ndarray:
    """numpy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Tag instrumentation
# ---------------------------------------------------------------------------
def make_tag_workload(n_read: int, n_write: int,
                      payload_words: int = 1) -> Workload:
    """Workload whose one branch blind-writes ``args[0]`` (the txn's tag)
    into word 0 of every write slot. Shapes mirror the workload being
    certified so the instrumented batch runs through the identical
    protocol machinery. The branch is batched, as every branch of the
    port: [T, Rd, D] reads -> [T, W, D] writes, word 0 the tag."""
    def tag_write(read_vals, args):
        w = torch.zeros((args.shape[0], n_write, payload_words),
                        dtype=torch.int32, device=args.device)
        w[:, :, 0] = args[:, :1]
        return w, torch.zeros(args.shape[0], dtype=torch.bool,
                              device=args.device)

    return Workload(name="tag", n_read=n_read, n_write=n_write,
                    payload_words=payload_words, branches=(tag_write,))


def tag_batch(batch: TxnBatch, offset: int = 0,
              device: DeviceLike = None) -> TxnBatch:
    """The instrumented twin of ``batch``: same read/write sets, one txn
    type, args[t] = offset + t + 1 (the tag), int32 on ``device``."""
    T = batch.size
    tags = np.arange(T, dtype=np.int64) + offset + 1
    return make_batch(batch.read_set, batch.write_set,
                      np.zeros(T, np.int64), tags[:, None], device=device)


# ---------------------------------------------------------------------------
# The serialization-graph checker
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Verdict:
    serializable: bool
    n_committed: int
    n_edges: int
    exact: bool                      # version order fully observed (RMW)
    cycle: Tuple[int, ...] = ()      # one offending txn cycle (empty if ok)
    reason: str = ""                 # non-graph failures (dirty read, ...)

    @property
    def label(self) -> str:
        return "serial-equivalent" if self.serializable else (
            f"NON-SERIALIZABLE({self.reason or 'cycle'})")


def _find_cycle(n: int, adj: Dict[int, set]) -> Tuple[int, ...]:
    """One cycle in the directed graph over nodes 0..n-1 (iterative DFS
    with colors); empty tuple when acyclic."""
    color = [0] * n                       # 0 white, 1 on stack, 2 done
    parent: Dict[int, int] = {}
    for root in range(n):
        if color[root]:
            continue
        stack: List[Tuple[int, object]] = [(root, iter(adj.get(root, ())))]
        color[root] = 1
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[node] = 2
                stack.pop()
                continue
            if color[nxt] == 1:           # back edge: recover the loop
                cyc = [nxt]
                cur = node
                while cur != nxt:
                    cyc.append(cur)
                    cur = parent[cur]
                return tuple(reversed(cyc))
            if color[nxt] == 0:
                color[nxt] = 1
                parent[nxt] = node
                stack.append((nxt, iter(adj.get(nxt, ()))))
    return ()


def certify(batch: TxnBatch, read_tags: np.ndarray,
            commit_mask: np.ndarray,
            final_tags: Optional[np.ndarray] = None, *,
            tag_offset: int = 0) -> Verdict:
    """Certify one instrumented protocol run as serial-equivalent.

    ``read_tags`` [T, Rd] are the word-0 values the committed txns
    observed, ``commit_mask`` [T] which txns committed, ``final_tags``
    [R] the committed word-0 state (None skips the final-state check).
    Values at or below ``tag_offset`` denote the pre-batch (initial)
    version; txn ``t``'s version carries ``tag_offset + t + 1``.
    """
    read_set = _host(batch.read_set)
    write_set = _host(batch.write_set)
    T = read_set.shape[0]
    mask = _host(commit_mask).astype(bool)
    read_tags = _host(read_tags)
    if final_tags is not None:
        final_tags = _host(final_tags)

    def writer_of(tag: int) -> int:
        return INIT if tag <= tag_offset else int(tag - tag_offset - 1)

    # committed writers per record (in ts order — np.unique is sorted)
    writers: Dict[int, List[int]] = {}
    for t in np.nonzero(mask)[0]:
        for r in write_set[t]:
            if r >= 0:
                writers.setdefault(int(r), [])
                if t not in writers[int(r)]:
                    writers[int(r)].append(int(t))

    # observed reads of committed txns: (reader, record, version writer)
    reads: List[Tuple[int, int, int]] = []
    for t in np.nonzero(mask)[0]:
        for j, r in enumerate(read_set[t]):
            if r < 0:
                continue
            w = writer_of(int(read_tags[t, j]))
            if w != INIT:
                if w >= T or not mask[w]:
                    return Verdict(False, int(mask.sum()), 0, True,
                                   reason="dirty-read")
                if int(r) not in write_set[w]:
                    return Verdict(False, int(mask.sum()), 0, True,
                                   reason="phantom-version")
            reads.append((int(t), int(r), w))
    reads_by_rec: Dict[int, List[Tuple[int, int]]] = {}
    for t, r, w in reads:
        reads_by_rec.setdefault(r, []).append((t, w))

    # version order per record: chain writers through their own reads
    # (RMW), else fall back to ts order (exact=False)
    exact = True
    order: Dict[int, List[int]] = {}
    for r, ws in writers.items():
        chain = None
        pred = {}
        for w in ws:
            slots = np.nonzero(read_set[w] == r)[0]
            if slots.size == 0:
                pred = None
                break
            pred[w] = writer_of(int(read_tags[w, slots[0]]))
        if pred is not None:
            by_pred = {p: w for w, p in pred.items()}
            if len(by_pred) == len(ws):     # each version extended once
                chain, cur = [], INIT
                while cur in by_pred:
                    cur = by_pred[cur]
                    chain.append(cur)
                if len(chain) != len(ws):
                    chain = None            # disconnected chain segments
        if chain is None:
            exact = False
            chain = sorted(ws)
        order[r] = chain
        if final_tags is not None:
            want = tag_offset + chain[-1] + 1
            if int(final_tags[r]) != want:
                return Verdict(False, int(mask.sum()), 0, exact,
                               reason="final-state")

    # MVSG edges over committed txns
    adj: Dict[int, set] = {}

    def edge(a: int, b: int) -> None:
        if a != b and a != INIT and b != INIT:
            adj.setdefault(a, set()).add(b)

    for r, chain in order.items():
        for a, b in zip(chain, chain[1:]):
            edge(a, b)                                   # ww
    succ = {(r, c[i]): c[i + 1]
            for r, c in order.items() for i in range(len(c) - 1)}
    succ.update({(r, INIT): c[0] for r, c in order.items() if c})
    for r, lst in reads_by_rec.items():
        for t, w in lst:
            edge(w, t)                                   # wr
            s = succ.get((r, w))
            if s is not None:
                edge(t, s)                               # rw
    n_edges = sum(len(v) for v in adj.values())
    cycle = _find_cycle(T, adj)
    return Verdict(not cycle, int(mask.sum()), n_edges, exact,
                   cycle=cycle, reason="cycle" if cycle else "")


# ---------------------------------------------------------------------------
# Adversarial-interleaving SI interpreter
# ---------------------------------------------------------------------------
def run_si_schedule(batch: TxnBatch, n_records: int,
                    begin_ep: Sequence[int], commit_ep: Sequence[int], *,
                    tag_offset: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Snapshot Isolation under an explicit begin/commit interleaving,
    on tag semantics (host-side — scenarios are small by construction).

    Each txn reads the latest version committed at an epoch <= its begin
    epoch; at commit (processed in (commit epoch, ts) order) it aborts iff
    a CONCURRENT txn — one that committed after this txn began — already
    committed a write to any record in its write set (first-committer-
    wins). ``begin_ep = 0, commit_ep = 1`` for every txn reproduces the
    batch-concurrent ``run_si`` baseline exactly (property-tested).

    Returns (final_tags [R], read_tags [T, Rd], commit_mask [T]).
    """
    read_set = _host(batch.read_set)
    write_set = _host(batch.write_set)
    T, Rd = read_set.shape
    begin_ep = _host(begin_ep)
    commit_ep = _host(commit_ep)
    if np.any(commit_ep <= begin_ep):
        raise ValueError("every txn must commit after it begins")
    # per-record version list: [(commit_epoch, ts, tag)], initial at -inf
    versions: Dict[int, List[Tuple[float, int, int]]] = {}

    def visible(r: int, ep: int) -> int:
        best = (-np.inf, -1, 0)
        for v in versions.get(r, []):
            if v[0] <= ep and v > best:
                best = v
        return best[2]

    read_tags = np.zeros((T, Rd), np.int64)
    commit_mask = np.zeros((T,), bool)
    final = np.zeros((n_records,), np.int64)
    for t in sorted(range(T), key=lambda t: (commit_ep[t], t)):
        for j, r in enumerate(read_set[t]):
            if r >= 0:
                read_tags[t, j] = visible(int(r), int(begin_ep[t]))
        aborted = any(
            v[0] > begin_ep[t]            # concurrent committer
            for r in write_set[t] if r >= 0
            for v in versions.get(int(r), []))
        if aborted:
            continue
        commit_mask[t] = True
        for r in write_set[t]:
            if r >= 0:
                versions.setdefault(int(r), []).append(
                    (float(commit_ep[t]), t, tag_offset + t + 1))
    for r, vs in versions.items():
        final[r] = max(vs)[2]
    return final, read_tags, commit_mask


# ---------------------------------------------------------------------------
# Scenario generators (parameterized — the gauntlet's diversity axis)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scenario:
    """One gauntlet scenario: read/write sets (the structure is all the
    certifier needs) plus the adversarial SI interleaving that exhibits
    the anomaly. ``expect_si_anomaly`` is the ground truth the property
    tests assert: SI's output must be flagged non-serializable exactly
    when it is True, and every serializable protocol must be certified
    serial-equivalent on the scenario batch regardless."""
    name: str
    n_records: int
    batch: TxnBatch
    si_begin: np.ndarray
    si_commit: np.ndarray
    expect_si_anomaly: bool


def _pad(rows: List[List[int]], width: int) -> np.ndarray:
    out = np.full((len(rows), width), -1, np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _scenario(name: str, reads, writes, width: int, n_records: int,
              begin, commit, expect: bool,
              device: DeviceLike = None) -> Scenario:
    batch = make_batch(_pad(reads, width), _pad(writes, width),
                       np.zeros(len(reads), np.int64),
                       np.zeros((len(reads), 1), np.int64), device=device)
    return Scenario(name, n_records, batch, np.asarray(begin),
                    np.asarray(commit), expect)


def write_skew_scenario(n_pairs: int = 4, n_noise: int = 0,
                        seed: int = 0,
                        device: DeviceLike = None) -> Scenario:
    """``n_pairs`` independent write-skew pairs: txn a reads {x, y} and
    writes x, txn b reads {x, y} and writes y. Under SI both read the
    common snapshot and commit (disjoint write sets) — the rw/rw cycle.
    ``n_noise`` plain RMW txns on a disjoint record band ride along so
    the checker proves itself on mixed batches."""
    rng = np.random.default_rng(seed)
    reads, writes, begin, commit = [], [], [], []
    for i in range(n_pairs):
        x, y = 2 * i, 2 * i + 1
        reads += [[x, y], [x, y]]
        writes += [[x], [y]]
        begin += [0, 0]
        commit += [1, 1]
    lo = 2 * n_pairs
    for _ in range(n_noise):
        r = int(rng.integers(lo, lo + max(n_noise, 1)))
        reads.append([r])
        writes.append([r])
        begin.append(0)
        commit.append(1)
    return _scenario(f"write-skew(p{n_pairs},n{n_noise},s{seed})",
                     reads, writes, 2, lo + max(n_noise, 1),
                     begin, commit, expect=n_pairs > 0, device=device)


def read_only_anomaly_scenario(n_triples: int = 2, seed: int = 0,
                               device: DeviceLike = None) -> Scenario:
    """Fekete et al.'s read-only anomaly, ``n_triples`` times over: T2
    deposits into y, T3 withdraws from x having read an OLD snapshot of
    {x, y}, and a read-only T1 — begun after T2's commit — observes
    {x0, y2}: T1's reads force T2 < T1 < T3 while T3's stale read of y
    forces T3 < T2. Without T1 the history is serializable (T3, T2) —
    the anomaly needs the read-only observer, which is why its SI
    schedule interleaves begins and commits."""
    reads, writes, begin, commit = [], [], [], []
    for i in range(n_triples):
        x, y = 2 * i, 2 * i + 1
        reads += [[y], [x, y], [x, y]]      # T2, T3, T1
        writes += [[y], [x], []]
        begin += [0, 0, 2]
        commit += [1, 4, 3]
    return _scenario(f"read-only-anomaly(t{n_triples},s{seed})",
                     reads, writes, 2, max(2 * n_triples, 1),
                     begin, commit, expect=n_triples > 0, device=device)


def rmw_control_scenario(n_txns: int = 8, n_records: int = 4,
                         seed: int = 0,
                         device: DeviceLike = None) -> Scenario:
    """Negative control: pure single-record RMW contention. SI's first-
    committer-wins admits only record-disjoint txns whose read sets equal
    their write sets — serializable by construction, so the checker must
    NOT flag it (guards against a trigger-happy certifier)."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, n_records, n_txns)
    reads = [[int(r)] for r in recs]
    return _scenario(f"rmw-control(t{n_txns},r{n_records},s{seed})",
                     reads, reads, 1, n_records,
                     [0] * n_txns, [1] * n_txns, expect=False,
                     device=device)


def default_scenarios(seed: int = 0,
                      device: DeviceLike = None) -> List[Scenario]:
    """The gauntlet's standing scenario set: anomalies at two sizes plus
    the serializable control."""
    return [
        write_skew_scenario(1, 0, seed, device),
        write_skew_scenario(4, 4, seed, device),
        read_only_anomaly_scenario(1, seed, device),
        read_only_anomaly_scenario(3, seed, device),
        rmw_control_scenario(8, 4, seed, device),
    ]
