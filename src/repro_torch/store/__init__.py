"""repro_torch.store — the persistent multiversion storage layer (port).

``ring``     single-shard per-record version rings, watermark GC and the
             ``commit_versions`` barrier step with pin-precise live/dead
             eviction accounting and per-record capacity (``k_eff``).
``spill``    the secondary tier: a bucketed pool shared across records
             that absorbs LIVE evictions from the primary rings.
``sharded``  ``ShardedVersionStore`` (one shard in this port so far):
             commit, GC and the two-level ``mvcc_resolve`` snapshot read.
"""
from repro_torch.store.ring import (AUDIT_COMMITTED, AUDIT_GC_RECLAIMED,
                                    AUDIT_OVERWROTE_DEAD,
                                    AUDIT_OVERWROTE_LIVE,
                                    AUDIT_PAGE_DROPPED, AUDIT_SPILL_DROPPED,
                                    AUDIT_SPILL_OVERWROTE, AUDIT_SPILLED,
                                    AUDIT_STATE_NAMES, INF_TS, VersionRing,
                                    commit_versions, gather_windows,
                                    gc_ring, init_ring, pin_stabbed,
                                    ring_fill_fraction, ring_occupancy)
from repro_torch.store.sharded import (ShardedVersionStore, commit_sharded,
                                       from_global, gather_windows_sharded,
                                       gc_sharded, init_sharded_store,
                                       resolve_sharded, store_occupancy,
                                       to_global)
from repro_torch.store.spill import (SpillPool, gc_spill, init_spill_pool,
                                     spill_buckets_for, spill_commit,
                                     spill_fill_fraction, spill_occupancy)

__all__ = [
    "AUDIT_COMMITTED", "AUDIT_GC_RECLAIMED", "AUDIT_OVERWROTE_DEAD",
    "AUDIT_OVERWROTE_LIVE", "AUDIT_PAGE_DROPPED", "AUDIT_SPILL_DROPPED",
    "AUDIT_SPILL_OVERWROTE", "AUDIT_SPILLED", "AUDIT_STATE_NAMES",
    "INF_TS", "VersionRing", "commit_versions", "gather_windows",
    "gc_ring", "init_ring", "pin_stabbed", "ring_fill_fraction",
    "ring_occupancy", "ShardedVersionStore", "commit_sharded",
    "from_global", "gather_windows_sharded", "gc_sharded",
    "init_sharded_store", "resolve_sharded", "store_occupancy",
    "to_global", "SpillPool", "gc_spill", "init_spill_pool",
    "spill_buckets_for", "spill_commit", "spill_fill_fraction",
    "spill_occupancy",
]
