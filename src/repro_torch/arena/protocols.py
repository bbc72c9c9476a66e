"""Common ``ProtocolEngine`` interface over all five concurrency-control
protocols (port of ``repro.arena.protocols``), so the arena matrix, the
anomaly gauntlet and the benchmark CLIs drive Bohm and the baselines
through one loop.

The contract (init store -> run batches -> stats):

  ``reset(base)``       reinitialise committed state;
  ``run_batch(batch)``  one update batch -> ``BatchOutput`` (read values,
                        commit mask, device metrics) — blocking;
  ``submit(batch)`` / ``finish()``
                        the streaming twin: non-blocking dispatch, one
                        join at the end (this is what throughput cells
                        time, and where Bohm's pipelined scheduler earns
                        its overlap);
  ``run_scan(batch)``   a read-only batch; Bohm serves it from a pinned
                        snapshot with ZERO concurrency-control
                        bookkeeping, baselines push it through their
                        normal round machinery;
  ``proxy_stats()``     protocol-native cost proxies, accumulated in the
                        shared ``repro_torch.obs.MetricsRegistry`` under
                        ``arena/<name>/`` (Hekaton's ``max_read_crowd``
                        read-counter crowd, OCC validation ``aborts``,
                        2PL ``lock_waits``, SI permanent ``aborts``,
                        Bohm ``waves`` + its identically-zero
                        ``read_bookkeeping_writes``);
  ``tag_twin()``        a fresh instance of the same protocol whose
                        workload blind-writes transaction tags
                        (``repro_torch.arena.anomalies``) — the
                        certification run rides the identical protocol
                        machinery.

Commit/abort/ordering decisions in every adapter depend only on the
read/write SETS of the batch, never on payload values: that is the
invariant that makes tag-replay certification sound, and
``tests/test_arena.py`` pins it (tag twin and real run commit the same
transactions).

Every adapter lives on one device (``device=``, default the card, as every
entry point of the port). The baseline runners of the port sync the host
once a round (``repro_torch.core.baselines``), so their ``submit`` blocks
where the reference's jitted ``while_loop`` only dispatches; ``finish``
ends in ``repro_torch.device.fence`` on the returned state either way,
which is what closes a timed window on the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.arena.anomalies import make_tag_workload
from repro_torch.core.baselines import run_2pl, run_hekaton, run_occ, run_si
from repro_torch.core.engine import BohmEngine
from repro_torch.core.txn import TxnBatch, Workload
from repro_torch.device import DeviceLike, fence, resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.service import TxnService


@dataclasses.dataclass(frozen=True)
class BatchOutput:
    """One batch's realised outputs under some protocol."""
    read_vals: torch.Tensor    # [T, Rd, D] values observed by each txn
    commit_mask: torch.Tensor  # [T] bool — False = permanent abort (SI)
    metrics: Dict[str, torch.Tensor]


class ProtocolEngine:
    """Base adapter: subclasses implement ``reset``/``run_batch``/
    ``finish`` (and optionally the streaming + scan paths)."""

    name: str = "?"
    #: registry keys (under ``arena/<name>/``) that are this protocol's
    #: headline cost proxies, in display order
    proxy_keys: tuple = ()

    def __init__(self, num_records: int, workload: Workload,
                 registry: Optional[MetricsRegistry] = None,
                 device: DeviceLike = None):
        self.num_records = num_records
        self.workload = workload
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.device = resolve_device(device)

    # -- interface ---------------------------------------------------------
    def reset(self, base: Optional[torch.Tensor] = None) -> None:
        raise NotImplementedError

    def run_batch(self, batch: TxnBatch) -> BatchOutput:
        raise NotImplementedError

    def run_batches(self, batches: Iterable[TxnBatch]
                    ) -> List[BatchOutput]:
        """Sequential batches with per-batch outputs retained (the
        certification path). Bohm overrides with a burst submit so epoch
        merging / pipelining is exercised too."""
        return [self.run_batch(b) for b in batches]

    def submit(self, batch: TxnBatch) -> None:
        """Non-blocking streaming dispatch; outputs are discarded, state
        folds forward. Join with ``finish``."""
        self.run_batch(batch)

    def finish(self) -> torch.Tensor:
        """Block until every submitted batch is committed; returns the
        final committed state [R, D]."""
        raise NotImplementedError

    def run_scan(self, batch: TxnBatch) -> torch.Tensor:
        """Read-only batch -> read values [T, Rd, D]."""
        return self.run_batch(batch).read_vals

    def tag_twin(self) -> "ProtocolEngine":
        raise NotImplementedError

    def proxy_stats(self) -> Dict[str, int]:
        """Host view of this protocol's ``arena/<name>/`` counters."""
        snap = self.registry.snapshot(include_gauges=False)
        pre = f"arena/{self.name}/"
        return {k[len(pre):]: int(v) for k, v in snap.items()
                if k.startswith(pre)}

    # -- shared helpers ----------------------------------------------------
    def _zero_base(self) -> torch.Tensor:
        return torch.zeros((self.num_records, self.workload.payload_words),
                           dtype=torch.int32, device=self.device)

    def _base_from(self, base) -> torch.Tensor:
        """``base`` as an int32 tensor on this adapter's device (a copy:
        the store never aliases the caller's tensor)."""
        if base is None:
            return self._zero_base()
        return torch.as_tensor(base).to(device=self.device,
                                        dtype=torch.int32, copy=True)

    def _bump(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Fold one batch's device metrics into the shared registry —
        lazy device adds (maxima for high-watermark proxies), no sync."""
        for key, val in metrics.items():
            if getattr(val, "ndim", 1):        # skip commit_mask etc.
                continue
            if key == "max_read_crowd":
                self.registry.accumulate_max(
                    f"arena/{self.name}/{key}", val)
            else:
                self.registry.accumulate(f"arena/{self.name}/{key}", val)


class BaselineProtocol(ProtocolEngine):
    """Adapter over the round-based baseline runners
    (``repro_torch.core.baselines``): single-version committed state, one
    runner call per batch (a Python loop over rounds, one host sync a
    round). All four runners share the uniform stats contract {rounds,
    aborts, commits, commit_mask} plus their protocol-native proxies."""

    _RUNNERS = {"2pl": run_2pl, "occ": run_occ,
                "si": run_si, "hekaton": run_hekaton}
    _PROXIES = {"2pl": ("rounds", "lock_waits"),
                "occ": ("rounds", "aborts"),
                "si": ("aborts",),
                "hekaton": ("rounds", "read_counter_bumps",
                            "max_read_crowd")}

    def __init__(self, name: str, num_records: int, workload: Workload,
                 registry: Optional[MetricsRegistry] = None,
                 device: DeviceLike = None):
        super().__init__(num_records, workload, registry, device)
        self.name = name
        self.proxy_keys = self._PROXIES[name]
        self._runner = functools.partial(
            self._RUNNERS[name], workload=workload,
            num_records=num_records)
        self._base = self._zero_base()

    def reset(self, base: Optional[torch.Tensor] = None) -> None:
        self._base = self._base_from(base)
        # the store's counters live and die with the store (same
        # lifecycle rule as the engine's reset_store)
        pre = f"arena/{self.name}/"
        for n in list(self.registry._device):
            if n.startswith(pre):
                self.registry.reset(n)

    def run_batch(self, batch: TxnBatch) -> BatchOutput:
        self._base, reads, metrics = self._runner(self._base, batch)
        self._bump(metrics)
        return BatchOutput(reads, metrics["commit_mask"], metrics)

    def finish(self) -> torch.Tensor:
        return fence(self._base)

    def tag_twin(self) -> "BaselineProtocol":
        return BaselineProtocol(
            self.name, self.num_records,
            make_tag_workload(self.workload.n_read,
                              self.workload.n_write), device=self.device)


class BohmProtocol(ProtocolEngine):
    """Bohm through the ``TxnService`` scheduler. ``conflict_aware=False``
    is the paper-faithful barriered variant (admission window 1, exec
    joins commit); ``conflict_aware=True`` enables the pipelined
    scheduler with a 4-batch admission window (epoch merging +
    exec/commit overlap). The engine keeps a PRIVATE engine registry so
    two Bohm variants in one arena never collide on ``engine/`` names;
    ``proxy_stats`` republishes the proxies under ``arena/<name>/`` in
    the shared registry."""

    def __init__(self, num_records: int, workload: Workload,
                 registry: Optional[MetricsRegistry] = None, *,
                 conflict_aware: bool = False, max_inflight: int = 2,
                 device: DeviceLike = None, **engine_kwargs):
        super().__init__(num_records, workload, registry, device)
        self.conflict_aware = bool(conflict_aware)
        self.name = "bohm-ca" if conflict_aware else "bohm"
        self.proxy_keys = ("waves", "read_bookkeeping_writes",
                           "merged_batches", "overlapped_execs")
        self._max_inflight = max_inflight
        self._engine_kwargs = dict(engine_kwargs)
        self.engine = BohmEngine(num_records, workload, device=self.device,
                                 **engine_kwargs)
        self._new_service()

    def _new_service(self) -> None:
        self.service = TxnService(
            self.engine, max_inflight=self._max_inflight,
            pipelined=self.conflict_aware,
            admission_window=4 if self.conflict_aware else 1)

    def reset(self, base: Optional[torch.Tensor] = None) -> None:
        # reset_store keeps the engine (and its registry) — only the store
        # and counters are rebuilt
        self.engine.reset_store(self._base_from(base))
        self._new_service()

    def _all_commit(self, batch: TxnBatch) -> torch.Tensor:
        # Bohm never aborts for concurrency control; SmallBank's
        # workload-logic aborts are not CC aborts
        return torch.ones((batch.size,), dtype=torch.bool,
                          device=self.device)

    def run_batch(self, batch: TxnBatch) -> BatchOutput:
        res = self.service.wait(self.service.submit(batch))
        return BatchOutput(res.read_vals, self._all_commit(batch),
                           res.metrics)

    def run_batches(self, batches: Iterable[TxnBatch]
                    ) -> List[BatchOutput]:
        batches = list(batches)
        tickets = self.service.submit_many(batches)
        return [BatchOutput(r.read_vals, self._all_commit(b), r.metrics)
                for b, r in zip(batches,
                                (self.service.wait(t) for t in tickets))]

    def submit(self, batch: TxnBatch) -> None:
        self.service.submit(batch)

    def finish(self) -> torch.Tensor:
        self.service.drain()
        return fence(self.engine.store.base)

    def run_scan(self, batch: TxnBatch) -> torch.Tensor:
        """The zero-bookkeeping read path: pin a snapshot, resolve the
        whole batch through the version rings in one step (the in-place
        resolve kernels) — no CC plan, no placeholder versions, no
        shared-state writes."""
        handle = self.service.begin_snapshot()
        try:
            vals, _, _ = self.service.run_readonly_batch(batch, handle.ts)
        finally:
            self.service.release_snapshot(handle)
        return vals

    def proxy_stats(self) -> Dict[str, int]:
        em = self.engine.metrics
        svc = em.view("service/")
        out = {"waves": int(em.value("engine/waves")),
               # Bohm's headline invariant: reads write NOTHING to shared
               # state (no read counters, no lock table) — identically 0
               # by construction, published so the proxy table shows the
               # contrast against Hekaton's read_counter_bumps
               "read_bookkeeping_writes": 0,
               "merged_batches": int(svc["merged_batches"]),
               "overlapped_execs": int(svc["overlapped_execs"])}
        for k, v in out.items():
            self.registry.set(f"arena/{self.name}/{k}", v)
        return out

    def tag_twin(self) -> "BohmProtocol":
        return BohmProtocol(
            self.num_records,
            make_tag_workload(self.workload.n_read,
                              self.workload.n_write),
            conflict_aware=self.conflict_aware,
            max_inflight=self._max_inflight, device=self.device,
            **self._engine_kwargs)


#: arena display order — Bohm variants first, then the baselines
PROTOCOL_NAMES = ("bohm", "bohm-ca", "hekaton", "occ", "2pl", "si")


def make_protocol(name: str, num_records: int, workload: Workload,
                  registry: Optional[MetricsRegistry] = None,
                  device: DeviceLike = None, **kwargs) -> ProtocolEngine:
    if name == "bohm":
        return BohmProtocol(num_records, workload, registry,
                            conflict_aware=False, device=device, **kwargs)
    if name == "bohm-ca":
        return BohmProtocol(num_records, workload, registry,
                            conflict_aware=True, device=device, **kwargs)
    if name in BaselineProtocol._RUNNERS:
        return BaselineProtocol(name, num_records, workload, registry,
                                device)
    raise ValueError(f"unknown protocol {name!r} "
                     f"(choose from {PROTOCOL_NAMES})")


def make_protocols(num_records: int, workload: Workload,
                   registry: Optional[MetricsRegistry] = None,
                   names: Iterable[str] = PROTOCOL_NAMES,
                   device: DeviceLike = None
                   ) -> Dict[str, ProtocolEngine]:
    """The full arena lineup sharing one metrics registry, every adapter
    on ``device``. Reuse the returned dict across matrix cells of
    identical shape: ``reset`` restores a fresh store in place."""
    registry = registry if registry is not None else MetricsRegistry()
    return {n: make_protocol(n, num_records, workload, registry, device)
            for n in names}
