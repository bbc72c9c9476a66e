"""repro_torch.store — the persistent multiversion storage layer (port).

``ring``     single-shard per-record version rings, watermark GC and the
             ``commit_versions`` barrier step with pin-precise live/dead
             eviction accounting and per-record capacity (``k_eff``).
``spill``    the secondary tier: a bucketed pool shared across records
             that absorbs LIVE evictions from the primary rings.
``pages``    paged physical storage: a page slab + per-record page tables
             replacing the dense [R, K] rings — cold records hold one
             page instead of ``k_max`` slots, pages move between records
             through a deterministic free list.
``policy``   adaptive-K reassignment (numpy host code at GC boundaries,
             page-quantized for the paged store, optional EWMA pressure
             decay).
``sharded``  ``ShardedVersionStore``: ``n_shards`` logical shards on one
             device (global record r at shard r % n), primary (rings or
             pages) + spill — commit, GC and the two-level snapshot read
             through the resolve kernels, reading the store in place.

Every commit path takes ``with_audit=True`` for the lifecycle audit
taps (``repro_torch.obs.lifecycle``); ``gc_sharded_audited`` is the
audited sweep. Not ported yet: the mesh substrate (``shard_map`` over a
device mesh).
"""
from repro_torch.store.pages import (PageSlab, commit_paged, free_page_count,
                                     gather_windows_paged, gc_pages,
                                     init_page_slab, mapped_page_count,
                                     mask_gathered_windows, page_owner_index,
                                     paged_occupancy, slab_fill_fraction)
from repro_torch.store.policy import (decay_pressure, reassign_k,
                                      reassign_stats)
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
                                       gc_sharded, gc_sharded_audited,
                                       global_record_ids,
                                       init_sharded_store,
                                       resolve_sharded, store_health,
                                       store_occupancy, to_global, unshard)
from repro_torch.store.spill import (SpillPool, gc_spill, init_spill_pool,
                                     spill_buckets_for, spill_commit,
                                     spill_fill_fraction, spill_occupancy)

__all__ = [
    "AUDIT_COMMITTED", "AUDIT_GC_RECLAIMED", "AUDIT_OVERWROTE_DEAD",
    "AUDIT_OVERWROTE_LIVE", "AUDIT_PAGE_DROPPED", "AUDIT_SPILL_DROPPED",
    "AUDIT_SPILL_OVERWROTE", "AUDIT_SPILLED", "AUDIT_STATE_NAMES",
    "gc_sharded_audited", "global_record_ids",
    "INF_TS", "VersionRing", "commit_versions", "gather_windows",
    "gc_ring", "init_ring", "pin_stabbed", "ring_fill_fraction",
    "ring_occupancy", "ShardedVersionStore", "commit_sharded",
    "from_global", "gather_windows_sharded", "gc_sharded",
    "init_sharded_store", "resolve_sharded", "store_health",
    "store_occupancy", "to_global", "unshard", "SpillPool", "gc_spill",
    "init_spill_pool", "spill_buckets_for", "spill_commit",
    "spill_fill_fraction", "spill_occupancy", "reassign_k",
    "reassign_stats", "decay_pressure", "PageSlab", "commit_paged",
    "free_page_count", "gather_windows_paged", "gc_pages",
    "init_page_slab", "mapped_page_count", "mask_gathered_windows",
    "page_owner_index", "paged_occupancy", "slab_fill_fraction",
]
