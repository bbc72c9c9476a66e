"""repro_torch.service — out-of-order transaction scheduling on the engine
(port of ``repro.service``).

``TxnService`` keeps >= 2 batches in flight: CC(b+1) is enqueued while
exec(b) runs (the paper's two-thread-pool overlap, Fig. 3), with an
admission queue, submit/poll/wait tickets, snapshot-aware watermarks and
a barriered mode for A/B measurement. With ``admission_window > 1`` the
queue becomes a conflict-aware window: queued batches with
pairwise-disjoint record footprints merge into one CC epoch, later
batches HOP over a conflicting one they commute with (timestamps
re-derived from dispatch order), interactive batches jump bulk work under
a ``max_hops`` starvation bound, and epochs disjoint from all uncommitted
predecessors chain their execs up to ``max_inflight_execs`` deep
(``benchmarks_torch/admission.py`` measures it; ``reorder=False`` keeps
the FIFO-prefix merge).
"""
from repro_torch.service.txn_service import (LATENCY_CLASSES, BatchResult,
                                             TxnService)

__all__ = ["BatchResult", "LATENCY_CLASSES", "TxnService"]
