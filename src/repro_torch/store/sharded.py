"""Record-partitioned version store: logical shards on one device, or
one shard a rank over a ``cc`` device mesh.

The port of ``repro.store.sharded``. Global record ``r`` is owned by
shard ``r % n`` at local index ``r // n``; the store keeps the
reference's stacked layout — a primary level of dense rings [n, Rl, K]
OR a paged slab [n, P, S] + page table [n, Rl, MaxP]
(``repro_torch.store.pages``), spill pools [n, B, S], ``k_eff``
[n, Rl] — with ``Rl = ceil(R / n)`` (records past ``R`` are
hash-padding: empty rings, no pages, never read or written), so state
carries across from a reference engine unchanged
(``repro_torch.core.carry``).

Two substrates share one per-shard body:

  * logical shards on one device (no mesh): the reference ``vmap``s the
    per-shard commit over the shard axis; here it is a loop over shards
    whose results are stacked (the per-shard arithmetic is the same, so
    the state is byte-equal);
  * a ``cc`` mesh (``init_sharded_store(mesh=)`` with the mesh's ``cc``
    size equal to ``n_shards`` > 1): every rank runs the same program
    (SPMD) and holds only its own shard. Each array of the store is a
    ``DTensor`` placed ``Shard(0)`` over the mesh — a caller sees the
    reference's global [n, ...] shape, and ``full_tensor()`` is the
    explicit read of the whole — whose local tensor is the rank's
    [1, ...] shard. ``shard_map`` (the reference's ``shard_map_compat``)
    hands the per-shard body the rank's local shard and its shard index
    (the rank in ``cc``) and wraps what the body returns back into
    DTensors; no torch op ever runs on the [n, ...] DTensors through
    DTensor's own dispatch. The collectives are few and explicit:
    commit gathers each shard's metrics (one all-gather), a resolve
    merges by ownership with one all-reduce SUM (the reference's
    ``psum``), GC sums its count (one all-reduce), and the host reads
    (``to_global``, ``unshard``, ``store_health``, the audited sweep)
    all-gather. Every rank issues them in the same order because every
    host branch reads replicated values.

The store's own placement picks the substrate: the functions that take
``mesh=`` accept it for the reference's signatures, and a store built
without a mesh runs logical shards (as the reference does when the
mesh's ``cc`` size differs from ``n_shards``).

At ``n_shards == 1`` ``commit_sharded`` and ``resolve_sharded`` keep
the reference's fast path, for two reasons. The loop would stack a copy
of the whole store every batch, where the fast path adds a shard axis
to a view. And the reference clamps a negative record id to 0 only on
that path (the loop's ownership test sends it to the last shard), which
the parity tests hold the port to. On both paths an id past the store
reads its shard's last row, as the reference's clamped gathers do.

Snapshot reads are two-level per shard: the primary goes through
``mvcc_resolve`` (dense: the ring's rows read in place) or
``mvcc_resolve_paged`` (paged: the page table's rows and the slab read
in place), then ``mvcc_resolve_masked`` reads the record's spill bucket
in place with the primary's result as its prior; at most one level
holds the visible version, so combining is a select, done inside that
launch. Each read has one owning shard; the shards' results merge by
ownership (foreign shards contribute zeros).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels import ops
from repro_torch.store.pages import (PageSlab, commit_paged, gc_pages,
                                     init_page_slab, mask_gathered_windows,
                                     page_owner_index, paged_occupancy,
                                     slab_fill_fraction)
from repro_torch.store.ring import (AUDIT_SPILL_DROPPED,
                                    AUDIT_SPILL_OVERWROTE, AUDIT_SPILLED,
                                    INF_TS, VersionRing, commit_versions,
                                    gc_ring, i32, isum, pin_stabbed,
                                    ring_occupancy)
from repro_torch.store.spill import (SpillPool, gc_spill, init_spill_pool,
                                     spill_commit, spill_fill_fraction,
                                     spill_occupancy)

PAD_KEY = 0xFFFFFFFF      # the plan's pad key (repro_torch.core.plan)

_EVICT_KEYS = ("evict_rec", "evict_begin", "evict_end", "evict_payload",
               "evict_valid")


@dataclasses.dataclass(frozen=True)
class ShardedVersionStore:
    """Primary version storage + spill pool stacked over a leading shard
    axis. The primary level is EITHER ``rings`` (dense [n, Rl, K]) OR
    ``pages`` (a paged slab [n, P, S] + page table [n, Rl, MaxP]);
    exactly one is set. ``k_eff`` [n, Rl] is each record's effective
    primary capacity (adaptive K; insertion-only — resolution and GC
    always scan all physical slots)."""
    rings: Optional[VersionRing]  # stacked: begin/end [n, Rl, K] or None
    spill: Optional[SpillPool]    # stacked [n, B, S, ...] or None
    k_eff: torch.Tensor           # [n, Rl] i32 per-record ring capacity
    num_records: int              # global record count (static)
    pages: Optional[PageSlab] = None   # stacked [n, P, S, ...] or None

    @property
    def paged(self) -> bool:
        return self.pages is not None

    @property
    def n_shards(self) -> int:
        return _primary_key(self).shape[0]

    @property
    def records_per_shard(self) -> int:
        return _primary_key(self).shape[1]

    @property
    def num_slots(self) -> int:
        """Logical slot ceiling per record (dense K, or MaxP * S)."""
        if self.rings is not None:
            return self.rings.begin.shape[2]
        return self.pages.page_table.shape[2] * self.pages.begin.shape[2]


def _primary_key(store: ShardedVersionStore) -> torch.Tensor:
    """The [n, Rl, ...] array that fixes the shard layout."""
    return (store.rings.begin if store.rings is not None
            else store.pages.page_table)


def _map(fn, obj):
    """Apply ``fn`` to every tensor field of a frozen dataclass."""
    return type(obj)(*(fn(getattr(obj, f.name))
                       for f in dataclasses.fields(obj)))


def _primary(store: ShardedVersionStore):
    """The stacked primary level: rings or pages (exactly one is set)."""
    return store.rings if store.rings is not None else store.pages


def _with_primary(store: ShardedVersionStore, prim) -> ShardedVersionStore:
    if store.rings is not None:
        return dataclasses.replace(store, rings=prim)
    return dataclasses.replace(store, pages=prim)


def _ring0(store: ShardedVersionStore):
    """The squeezed single primary (ring or slab) of an n_shards == 1
    store."""
    return _take_shard(store, 0)


def _take_shard(store: ShardedVersionStore, s: int):
    """Shard ``s``'s primary (ring or slab), the shard axis dropped."""
    return _map(lambda x: x[s], _primary(store))


def _stack(parts):
    """Stack per-shard dataclasses (rings, slabs, pools) along a new
    leading shard axis."""
    first = parts[0]
    return type(first)(*(torch.stack([getattr(p, f.name) for p in parts])
                         for f in dataclasses.fields(first)))


def _take_spill(store: ShardedVersionStore, s: int) -> Optional[SpillPool]:
    if store.spill is None:
        return None
    return _map(lambda x: x[s], store.spill)


# ---------------------------------------------------------------------------
# The mesh substrate: the rank's shard, the mapping helper, the collectives.
# ---------------------------------------------------------------------------
def cc_size(mesh, axis: str = "cc") -> int:
    """The size of ``mesh``'s ``axis`` dim; 0 when there is no mesh or it
    has no such dim (the reference's ``axis in mesh.shape`` test)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names:
        return 0
    return int(mesh.size(names.index(axis)))


def cc_submesh(mesh, axis: str = "cc"):
    """The one-dim ``axis`` mesh of ``mesh`` (``mesh`` itself when it has
    no other dim)."""
    return mesh if mesh.ndim == 1 else mesh[axis]


def store_mesh(store: ShardedVersionStore):
    """The one-dim mesh a store is sharded over, or None for logical
    shards."""
    k = store.k_eff
    return k.device_mesh if isinstance(k, DTensor) else None


def _tree(fn, obj):
    """Apply ``fn`` to every tensor in ``obj`` (a tensor, None, or a
    dataclass / tuple / list / dict of them, nested)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if obj is None or isinstance(obj, (int, float, bool, str)):
        return obj
    if dataclasses.is_dataclass(obj):
        return type(obj)(*(_tree(fn, getattr(obj, f.name))
                           for f in dataclasses.fields(obj)))
    if isinstance(obj, dict):
        return {k: _tree(fn, v) for k, v in obj.items()}
    return type(obj)(_tree(fn, v) for v in obj)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _shard(local: torch.Tensor, mesh) -> DTensor:
    """A rank's [1, ...] shard as the [n, ...] DTensor placed Shard(0)."""
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False)


def shard_map(fn, mesh, *args):
    """Run a per-shard body on this rank's shard: every DTensor in
    ``args`` becomes its local [1, ...] tensor, and ``fn(shard, *args)``
    gets the rank's shard index first. ``fn`` returns ``(sharded,
    replicated)``: each tensor of ``sharded`` is the rank's [1, ...]
    shard and comes back as the [n, ...] DTensor; ``replicated`` comes
    back as it is. The port's counterpart of the reference's
    ``shard_map_compat``: the reference's three shard_map sites (the CC
    plan, commit, resolve) and the functions it leaves to jit's
    partitioner all go through it."""
    sharded, replicated = fn(mesh.get_local_rank(), *_tree(_local, args))
    return _tree(lambda x: _shard(x, mesh), sharded), replicated


def map_shards(fn, *xs):
    """``fn(*xs)`` for a shard-wise ``fn`` (elementwise, or one that works
    row by row): on DTensors ``fn`` of the rank's shards, wrapped back."""
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    return shard_map(lambda s, *loc: (fn(*loc), None), xs[0].device_mesh,
                     *xs)[0]


def _group(mesh):
    return mesh.get_group()


def all_gather(local: torch.Tensor, mesh) -> torch.Tensor:
    """[...] on every rank -> [n, ...], rank order."""
    n = mesh.size()
    out = local.new_empty((n * local.numel(),))
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, local.contiguous().reshape(-1), group=_group(mesh))
    return out.reshape((n,) + tuple(local.shape))


def all_reduce(x: torch.Tensor, mesh, op=None) -> torch.Tensor:
    """In-place all-reduce of ``x`` over the mesh (SUM unless ``op``)."""
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=_group(mesh))
    return x


def gather_many(tensors, mesh) -> list:
    """All-gather several tensors in ONE collective: each rank packs them
    into one float64 vector (exact for int32, int64 below 2^53, bool and
    float32 values), the gather stacks the ranks, and each comes back as
    [n, *its shape] in its own dtype."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    rows = all_gather(flat, mesh)
    out, off = [], 0
    for t in tensors:
        k = t.numel()
        out.append(rows[:, off:off + k].reshape(
            (rows.shape[0],) + tuple(t.shape)).to(t.dtype))
        off += k
    return out


def full(x):
    """The whole [n, ...] tensor of a DTensor sharded over a mesh (an
    all-gather every rank joins); any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return all_gather(x.to_local(), x.device_mesh).reshape(x.shape)


def full_store(store: ShardedVersionStore) -> ShardedVersionStore:
    """The store with every array whole on this rank (the logical layout
    the same state has on one device); a logical store as it is."""
    if store_mesh(store) is None:
        return store
    return _tree(full, store)


def distribute_store(store: ShardedVersionStore, mesh
                     ) -> ShardedVersionStore:
    """A logical [n, ...] store sharded over ``mesh``: each rank keeps its
    own row of every array (as DTensors). Inverse of ``full_store``."""
    s = mesh.get_local_rank()
    return _tree(lambda x: _shard(x[s:s + 1].contiguous(), mesh), store)


def local_store(store: ShardedVersionStore) -> ShardedVersionStore:
    """The rank's shard as a one-shard logical store (the mesh store's
    local tensors)."""
    return _tree(_local, store)


def sum_over_shards(fn, x) -> torch.Tensor:
    """``fn(x)`` for a reduction ``fn`` that sums over the shard axis
    (and more): on a mesh, ``fn`` of the rank's shard summed over the
    ranks."""
    if not isinstance(x, DTensor):
        return fn(x)
    return all_reduce(fn(x.to_local()), x.device_mesh)


def init_sharded_store(base: torch.Tensor,
                       base_ts: Optional[torch.Tensor] = None,
                       num_slots: int = 4, n_shards: int = 1,
                       spill_buckets: int = 0, spill_slots: int = 0,
                       k_init: Optional[int] = None, paged: bool = False,
                       page_slots: int = 4,
                       pages_per_shard: Optional[int] = None,
                       mesh=None, axis: str = "cc"
                       ) -> ShardedVersionStore:
    """Store whose slot 0 holds the initial open version of every record;
    ``spill_buckets`` x ``spill_slots`` > 0 attaches a spill pool;
    ``k_init`` caps each record's effective capacity below the physical
    ``num_slots`` (the adaptive-K starting point).

    ``paged=True`` replaces the dense [R, K] ring with a page slab of
    ``pages_per_shard`` pages of ``page_slots`` slots and page tables of
    ``ceil(num_slots / page_slots)`` entries; every record starts with
    exactly its initial page. Global record ``r`` lands at
    ``[r % n_shards, r // n_shards]``.

    ``mesh`` whose ``axis`` size equals ``n_shards`` > 1 shards the store
    over the mesh: each rank allocates only its own shard (``base`` is
    the replicated head store) and every array is a DTensor placed
    Shard(0). Any other mesh leaves the store logical."""
    R, D = base.shape
    dev = base.device
    if base_ts is None:
        base_ts = torch.zeros((R,), dtype=torch.int32, device=dev)
    n = int(n_shards)
    if n < 1:
        raise ValueError("n_shards must be >= 1")
    on_mesh = n > 1 and cc_size(mesh, axis) == n
    if on_mesh:
        mesh = cc_submesh(mesh, axis)
        shards = [mesh.get_local_rank()]
    else:
        shards = list(range(n))
    Rl = -(-R // n)
    pad = Rl * n - R
    basep = torch.cat([base, base.new_zeros((pad, D))])
    tsp = torch.cat([base_ts.to(torch.int32),
                     torch.zeros((pad,), dtype=torch.int32, device=dev)])
    ix = torch.tensor(shards, device=dev)
    base_sh = basep.reshape(Rl, n, D).movedim(0, 1)[ix]     # [m, Rl, D]
    ts_sh = tsp.reshape(Rl, n).T[ix]                         # [m, Rl]
    real = global_record_ids(n, Rl, dev)[ix] < R             # [m, Rl]
    m = len(shards)
    rings = pages = None
    if paged:
        max_pages = -(-int(num_slots) // int(page_slots))
        if pages_per_shard is None:
            # per-record ceiling, NOT the pooled slot budget: every record
            # needs ceil(k / S) whole pages to physically reach its k_eff
            pages_per_shard = Rl * -(-int(k_init or num_slots)
                                     // int(page_slots))
        pages = _stack([init_page_slab(base_sh[i], ts_sh[i], real[i],
                                       pages_per_shard, page_slots,
                                       max_pages) for i in range(m)])
    else:
        begin = torch.full((m, Rl, num_slots), INF_TS, dtype=torch.int32,
                           device=dev)
        begin[:, :, 0] = torch.where(real, ts_sh, INF_TS)
        end = torch.full((m, Rl, num_slots), INF_TS, dtype=torch.int32,
                         device=dev)
        payload = torch.zeros((m, Rl, num_slots, D), dtype=base.dtype,
                              device=dev)
        payload[:, :, 0, :] = torch.where(real[..., None], base_sh, 0)
        head = torch.full((m, Rl), 1 % num_slots, dtype=torch.int32,
                          device=dev)
        rings = VersionRing(begin=begin, end=end, payload=payload,
                            head=head)
    spill = None
    if int(spill_buckets) > 0 and int(spill_slots) > 0:
        pool = init_spill_pool(spill_buckets, spill_slots, D, base.dtype,
                               dev)
        spill = _map(lambda x: x[None].repeat((m,) + (1,) * x.dim()), pool)
    k0 = num_slots if k_init is None else min(int(k_init), num_slots)
    store = ShardedVersionStore(
        rings=rings, spill=spill,
        k_eff=torch.full((m, Rl), k0, dtype=torch.int32, device=dev),
        num_records=R, pages=pages)
    if on_mesh:
        store = _tree(lambda x: _shard(x, mesh), store)
    return store


def global_record_ids(n_shards: int, records_per_shard: int,
                      device=None) -> torch.Tensor:
    """[n, Rl] global record id at each sharded position."""
    local = torch.arange(records_per_shard, dtype=torch.int32,
                         device=device)[None, :]
    shard = torch.arange(n_shards, dtype=torch.int32, device=device)[:, None]
    return local * n_shards + shard


def unshard(store: ShardedVersionStore) -> VersionRing:
    """Materialise the global [R, K] ring. Tests/debug only."""
    if store.rings is None:
        raise ValueError("unshard materialises dense rings; a paged "
                         "store has no global [R, K] layout — compare "
                         "reads (resolve_sharded) or use "
                         "gather_windows_sharded instead")
    return _map(lambda x: to_global(store, x), store.rings)


def to_global(store: ShardedVersionStore,
              per_shard: torch.Tensor) -> torch.Tensor:
    """Re-index a per-shard [n, Rl] record statistic to global [R] (on a
    mesh: gathered, the same on every rank)."""
    n, Rl = store.n_shards, store.records_per_shard
    per_shard = full(per_shard)
    return per_shard.movedim(0, 1).reshape(
        (Rl * n,) + tuple(per_shard.shape[2:]))[:store.num_records]


def from_global(store: ShardedVersionStore, per_record: torch.Tensor,
                pad_value: int = 0) -> torch.Tensor:
    """Inverse of ``to_global`` (hash-padding records get ``pad_value``);
    on a mesh each rank keeps its own shard's row."""
    n, Rl = store.n_shards, store.records_per_shard
    pad = Rl * n - store.num_records
    fill = torch.full((pad,) + tuple(per_record.shape[1:]), pad_value,
                      dtype=per_record.dtype, device=per_record.device)
    padded = torch.cat([per_record, fill])
    out = padded.reshape((Rl, n) + tuple(per_record.shape[1:])).movedim(
        0, 1)
    mesh = store_mesh(store)
    if mesh is None:
        return out
    s = mesh.get_local_rank()
    return _shard(out[s:s + 1].contiguous(), mesh)


def _occupancy(store: ShardedVersionStore) -> torch.Tensor:
    """[n, Rl] live version count per record."""
    mesh = store_mesh(store)
    if mesh is not None:
        return shard_map(lambda s, loc: (_occupancy(loc), None), mesh,
                         store)[0]
    if store.rings is not None:
        return ring_occupancy(store.rings)
    return torch.stack([paged_occupancy(_take_shard(store, s))
                        for s in range(store.n_shards)])


def store_occupancy(store: ShardedVersionStore) -> torch.Tensor:
    """[R] live version count per global record."""
    return to_global(store, _occupancy(store))


def store_health(store: ShardedVersionStore) -> Dict[str, torch.Tensor]:
    """Per-shard health gauges as device tensors (nothing here
    synchronises; on a mesh one all-gather):

      live_versions [n]   live version count per shard
      k_eff_slots   [n]   effective (policy-granted) slot capacity
      pages_mapped / pages_free / slab_fill [n]  (paged stores)
      spill_occupancy / spill_fill [n]           (spill tier attached)
    """
    mesh = store_mesh(store)
    if mesh is not None:
        out = store_health(local_store(store))
        rows = gather_many(list(out.values()), mesh)
        return {k: v.reshape(-1) for k, v in zip(out, rows)}
    out: Dict[str, torch.Tensor] = {
        "k_eff_slots": store.k_eff.sum(-1, dtype=torch.int32),
        "live_versions": _occupancy(store).sum(-1, dtype=torch.int32)}
    shards = range(store.n_shards)
    if store.pages is not None:
        mapped = (store.pages.page_table >= 0).sum((1, 2),
                                                   dtype=torch.int32)
        out["pages_mapped"] = mapped
        out["pages_free"] = store.pages.num_pages - mapped
        out["slab_fill"] = torch.stack([
            slab_fill_fraction(_take_shard(store, s)) for s in shards])
    if store.spill is not None:
        pools = [_take_spill(store, s) for s in shards]
        out["spill_occupancy"] = torch.stack([spill_occupancy(p)
                                              for p in pools])
        out["spill_fill"] = torch.stack([spill_fill_fraction(p)
                                         for p in pools])
    return out


def spill_bucket(store: ShardedVersionStore, record: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rec, begin, end) [S] of the spill bucket that holds ``record``'s
    spilled versions (shard-local record ids; on a mesh one all-gather).
    Requires a spill tier."""
    n = store.n_shards
    shard, loc = record % n, record // n
    sp = store.spill
    bkt = loc % sp.num_buckets
    mesh = store_mesh(store)
    if mesh is None:
        return sp.rec[shard, bkt], sp.begin[shard, bkt], sp.end[shard, bkt]
    mine = local_store(store).spill
    rows = all_gather(torch.stack([mine.rec[0, bkt], mine.begin[0, bkt],
                                   mine.end[0, bkt]]), mesh)[shard]
    return rows[0], rows[1], rows[2]


# ---------------------------------------------------------------------------
# Commit: per-shard ring maintenance (GC + insert) then the spill tier.
# ---------------------------------------------------------------------------
def _mask_to_shard(n: int, shard: int, w_rec, w_key, w_valid):
    """Project global placeholder arrays onto one shard: foreign records
    become pads (key 0xFFFFFFFF sorts last, valid=False drops the write),
    owned records map to their shard-local index. rec -> rec // n is
    monotone over the records a shard owns, so the key order holds."""
    owned = w_valid & ((w_rec % n) == shard)
    rec_l = torch.where(owned, torch.div(w_rec, n, rounding_mode="floor"),
                        INF_TS).to(w_rec.dtype)
    key_l = torch.where(owned, w_key, PAD_KEY)
    return rec_l, key_l, owned


def _commit_one_shard(ring_s, spill_s: Optional[SpillPool],
                      k_eff_s: torch.Tensor, rec_l, key_l, owned,
                      w_begin_ts, w_end_ts, w_data, watermark, ts_window,
                      pin_ts, with_audit: bool = False):
    """One shard's commit: primary maintenance (dense ring or paged slab
    — same contract, dispatched on the type), then its live evictees
    into the spill pool at the same clamped watermark.

    ``with_audit=True`` emits the lifecycle audit arrays
    (``audit_rec/begin/end/state``, shard-LOCAL record ids): the
    primary's 3 segments plus, with a spill pool, each evictee's
    placement (SPILLED / SPILL_DROPPED) and the spill versions those
    placements destroyed (SPILL_OVERWROTE)."""
    with_spill = spill_s is not None
    commit_fn = commit_paged if isinstance(ring_s, PageSlab) \
        else commit_versions
    ring_o, m = commit_fn(ring_s, rec_l, key_l, owned, w_begin_ts,
                          w_end_ts, w_data, watermark, ts_window=ts_window,
                          k_eff=k_eff_s, pin_ts=pin_ts,
                          with_evictees=with_spill, with_audit=with_audit)
    if with_spill:
        ev = {k: m.pop(k) for k in _EVICT_KEYS}
        wm = i32(watermark, w_data.device)
        if ts_window is not None:
            wm = torch.minimum(wm, i32(ts_window[0], w_data.device))
        spill_s, sm = spill_commit(spill_s, ev["evict_rec"],
                                   ev["evict_begin"], ev["evict_end"],
                                   ev["evict_payload"], ev["evict_valid"],
                                   wm, pin_ts=pin_ts, with_audit=with_audit)
        if with_audit:
            placed = sm.pop("spill_audit_placed")
            v_valid = sm.pop("spill_victim_valid")
            v_rec = sm.pop("spill_victim_rec")
            v_begin = sm.pop("spill_victim_begin")
            v_end = sm.pop("spill_victim_end")
            zero = torch.zeros_like(v_rec)
            sp_state = torch.where(
                placed, AUDIT_SPILLED,
                torch.where(ev["evict_valid"], AUDIT_SPILL_DROPPED, zero))
            vic_state = torch.where(v_valid, AUDIT_SPILL_OVERWROTE, zero)
            for key, seg in (("audit_rec", (ev["evict_rec"], v_rec)),
                             ("audit_begin", (ev["evict_begin"], v_begin)),
                             ("audit_end", (ev["evict_end"], v_end)),
                             ("audit_state", (sp_state, vic_state))):
                m[key] = torch.cat([m[key], *seg])
        m.update(sm)
    return ring_o, spill_s, m


_PER_RECORD = ("ring_overwrote_rec", "ring_overwrote_dead_rec")


def commit_sharded(store: ShardedVersionStore, w_rec: torch.Tensor,
                   w_key: torch.Tensor, w_valid: torch.Tensor,
                   w_begin_ts: torch.Tensor, w_end_ts: torch.Tensor,
                   w_data: torch.Tensor, watermark, mesh=None,
                   axis: str = "cc", ts_window: Optional[Tuple] = None,
                   pin_ts: Optional[torch.Tensor] = None,
                   with_audit: bool = False
                   ) -> Tuple[ShardedVersionStore, Dict[str, torch.Tensor]]:
    """Commit ALL batch versions into the primary (and live evictees
    into the spill pool). Each shard commits only the records it owns;
    the metrics aggregate to the single-primary contract, except
    ``ring_overwrote_rec`` / ``ring_overwrote_dead_rec``, which keep the
    per-shard [n, Rl] layout as in the reference; a paged store adds the
    allocator's counters. ``with_audit=True`` adds ``ring_committed`` and
    the lifecycle audit arrays flattened over shards, record ids GLOBAL
    (-1 where the state is 0) — device tensors; nothing synchronises.

    A store sharded over a mesh commits each rank's shard in the rank
    (``shard_map``): the inputs are the merged plan's global arrays,
    identical on every rank; one all-gather brings every shard's metrics
    to every rank (the per-record pair stays sharded), so they aggregate
    as the logical shards' do."""
    n = store.n_shards
    if n == 1:
        ring, spill0, metrics = _commit_one_shard(
            _ring0(store), _take_spill(store, 0), store.k_eff[0], w_rec,
            w_key, w_valid, w_begin_ts, w_end_ts, w_data, watermark,
            ts_window, pin_ts, with_audit=with_audit)
        for k in _PER_RECORD:
            metrics[k] = metrics[k][None]
        if with_audit:
            metrics["audit_rec"] = torch.where(
                metrics["audit_state"] > 0, metrics["audit_rec"], -1)
        new_spill = None if spill0 is None else _map(lambda x: x[None],
                                                     spill0)
        return dataclasses.replace(
            _with_primary(store, _map(lambda x: x[None], ring)),
            spill=new_spill), metrics

    def one_shard(s, prim, spill, k_eff):
        rec_l, key_l, owned = _mask_to_shard(n, s, w_rec, w_key, w_valid)
        return _commit_one_shard(prim, spill, k_eff, rec_l, key_l, owned,
                                 w_begin_ts, w_end_ts, w_data, watermark,
                                 ts_window, pin_ts, with_audit=with_audit)

    on_mesh = store_mesh(store)
    if on_mesh is not None:
        def body(s, loc):
            prim_s, spill_s, m = one_shard(s, _take_shard(loc, 0),
                                           _take_spill(loc, 0),
                                           loc.k_eff[0])
            grow = (lambda x: x[None])
            return ((_map(grow, prim_s),
                     None if spill_s is None else _map(grow, spill_s),
                     {k: m.pop(k)[None] for k in _PER_RECORD}), m)

        (prim, new_spill, per), m = shard_map(body, on_mesh, store)
        keys = list(m)
        per.update(zip(keys, gather_many([m[k] for k in keys], on_mesh)))
    else:
        prims, spills, parts = [], [], []
        for s in range(n):
            prim_s, spill_s, m = one_shard(s, _take_shard(store, s),
                                           _take_spill(store, s),
                                           store.k_eff[s])
            prims.append(prim_s)
            spills.append(spill_s)
            parts.append(m)
        prim = _stack(prims)
        new_spill = None if store.spill is None else _stack(spills)
        per = {k: torch.stack([m[k] for m in parts]) for k in parts[0]}

    def total(key):
        return per[key].sum(dtype=torch.int32)

    metrics = {k: total(k) for k in ("ring_evicted",
                                     "ring_overflow_dropped",
                                     "ring_overwrote_live",
                                     "ring_overwrote_dead")}
    for k in _PER_RECORD:
        metrics[k] = per[k]                                    # [n, Rl]
    metrics["ring_occ_max"] = per["ring_occ_max"].max()
    # per-shard means weight hash-padding records with 0 occupancy;
    # renormalise to the real record count
    metrics["ring_occ_mean"] = per["ring_occ_mean"].sum() \
        * store.records_per_shard / store.num_records
    if store.paged:
        for k in ("paged_alloc_failed", "paged_pages_allocated",
                  "paged_pages_free"):
            metrics[k] = total(k)
    if store.spill is not None:
        for k in ("spill_freed", "spill_admitted", "spill_dropped",
                  "spill_overwrote", "spill_overwrote_pinned",
                  "spill_occupancy"):
            metrics[k] = total(k)
    if with_audit:
        metrics["ring_committed"] = total("ring_committed")
        # shard-local ids -> global (r = local * n + shard), flattened
        # over the shard axis; masked entries stay rec = -1
        state = per["audit_state"]
        shard_ix = torch.arange(n, dtype=torch.int32,
                                device=state.device)[:, None]
        metrics["audit_rec"] = torch.where(
            state > 0, per["audit_rec"] * n + shard_ix, -1).reshape(-1)
        for k in ("audit_begin", "audit_end"):
            metrics[k] = per[k].reshape(-1)
        metrics["audit_state"] = state.reshape(-1)
    return dataclasses.replace(_with_primary(store, prim),
                               spill=new_spill), metrics


def gc_sharded(store: ShardedVersionStore, watermark
               ) -> Tuple[ShardedVersionStore, torch.Tensor]:
    """Standalone watermark GC sweep over the primary and the spill pool
    (see ``gc_ring`` / ``gc_pages`` / ``gc_spill``). The paged sweep also
    returns fully drained stranded pages to the free list. On a mesh each
    rank sweeps its shard and the counts are summed (one all-reduce)."""
    mesh = store_mesh(store)
    if mesh is not None:
        swept, evicted = shard_map(lambda s, loc: gc_sharded(loc, watermark),
                                   mesh, store)
        return swept, all_reduce(evicted, mesh)
    if store.rings is not None:
        prim, evicted = gc_ring(store.rings, watermark)
    else:
        swept = [gc_pages(_take_shard(store, s), watermark, store.k_eff[s])
                 for s in range(store.n_shards)]
        prim = _stack([slab for slab, _ in swept])
        evicted = torch.stack([e for _, e in swept]).sum(dtype=torch.int32)
    spill = store.spill
    if spill is not None:
        spill, freed = gc_spill(spill, watermark)
        evicted = evicted + freed
    return dataclasses.replace(_with_primary(store, prim),
                               spill=spill), evicted


def _audit_dead_parts(store: ShardedVersionStore, watermark, n: int,
                      shards: torch.Tensor) -> list:
    """Every version the sweep at ``watermark`` is about to reclaim, one
    level at a time — primary (dense or paged), then spill — as flat
    parallel (rec_global, begin, end, dead) arrays. ``shards`` [m] are
    the global shard ids of the store's m stacked shards out of ``n``.
    Record ids are global (-1 where not reclaimed / unowned)."""
    Rl = store.records_per_shard
    dev = _primary_key(store).device
    wm = i32(watermark, dev)
    shard = shards.to(torch.int32)[:, None]
    parts = []
    if store.rings is not None:
        r = store.rings
        dead = (r.begin != INF_TS) & (r.end <= wm)         # [m, Rl, K]
        local = torch.arange(Rl, dtype=torch.int32, device=dev)[None, :]
        rec_g = (local * n + shard)[..., None].expand(dead.shape)
        parts.append((rec_g, r.begin, r.end, dead))
    else:
        p = store.pages
        dead = (p.begin != INF_TS) & (p.end <= wm)         # [m, P, S]
        owner = torch.stack([page_owner_index(p.page_table[i],
                                              p.num_pages)[0]
                             for i in range(dead.shape[0])])   # [m, P]
        rec_g = torch.where(owner >= 0, owner * n + shard, -1)
        rec_g = rec_g[..., None].expand(dead.shape)
        parts.append((rec_g, p.begin, p.end, dead & (rec_g >= 0)))
    if store.spill is not None:
        sp = store.spill
        dead = (sp.rec >= 0) & (sp.end <= wm)              # [m, B, S]
        rec_g = torch.where(sp.rec >= 0, sp.rec * n + shard[..., None], -1)
        parts.append((rec_g, sp.begin, sp.end, dead))
    return [(torch.where(d, r, -1).reshape(-1), b.reshape(-1),
             e.reshape(-1), d.reshape(-1)) for r, b, e, d in parts]


def _first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=len(mask))[0]``: the
    first ``size`` true positions in ascending order, padded with
    ``len(mask)``. A cumsum compaction, so it never synchronises (
    ``torch.nonzero`` would, to size its output)."""
    n_flat = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    take = mask & (pos < size)
    out = torch.full((size + 1,), n_flat, dtype=torch.int64,
                     device=mask.device)
    out.index_copy_(0, torch.where(take, pos, size),
                    torch.arange(n_flat, device=mask.device))
    return out[:size]


def _take_events(rec, begin, end, dead, cap: int):
    """The first ``cap`` reclaimed versions of flat arrays, padded with
    rec -1 / INF_TS."""
    idx = _first_true(dead, cap)

    def take(x, fill):
        return torch.cat([x, torch.full((1,), fill, dtype=x.dtype,
                                        device=x.device)])[idx]

    return take(rec, -1), take(begin, INF_TS), take(end, INF_TS)


def _gc_stats(rec, begin, end, dead, wm, pin_ts):
    """The sweep's delay and pin statistics over flat arrays."""
    delay = torch.where(dead, wm - end, 0)
    # float32 log2, as the reference computes the bucket
    bucket = torch.floor(torch.log2(delay.to(torch.float32) + 1.0)) \
        .clamp(0, 15).to(torch.int64)
    hist = torch.zeros(17, dtype=torch.int32, device=wm.device)
    hist.index_add_(0, torch.where(dead, bucket, 16),
                    torch.ones_like(bucket, dtype=torch.int32))
    stabbed = dead & pin_stabbed(begin, end, pin_ts)
    return {"gc_dead_total": isum(dead), "gc_delay_sum": isum(delay),
            "gc_delay_max": delay.max(), "gc_delay_hist": hist[:16],
            "gc_pin_stabbed": isum(stabbed)}


def gc_sharded_audited(store: ShardedVersionStore, watermark,
                       pin_ts: Optional[torch.Tensor] = None,
                       event_cap: int = 256
                       ) -> Tuple[ShardedVersionStore, torch.Tensor,
                                  Dict[str, torch.Tensor]]:
    """``gc_sharded`` plus the GC audit: the death->reclamation delay
    of each reclaimed version and a certification that no registered
    pin could still stab one (see ``repro.store.sharded
    .gc_sharded_audited``). Returns ``(store, evicted, audit)``; every
    audit value is a device tensor:

      gc_watermark      []    the sweep's watermark
      gc_dead_total     []    versions reclaimed by this sweep
      gc_delay_sum/max  []    sum / max of (watermark - end) over them
      gc_delay_hist     [16]  log2-bucketed delay histogram
      gc_pin_stabbed    []    reclaimed versions a pin stabs (cert == 0)
      gc_event_rec/begin/end [event_cap]  the first ``event_cap``
                        reclaimed versions (global rec, -1/INF padded)

    The events are the first in the reference's flat order: every
    shard's primary level, then every shard's spill pool. On a mesh each
    rank audits its shard and one all-gather brings every rank's counts
    and its first ``event_cap`` events of each level to every rank,
    which reduce and merge them in that order."""
    n, cap = store.n_shards, int(event_cap)
    dev = _primary_key(store).device
    wm = i32(watermark, dev)
    mesh = store_mesh(store)
    if mesh is None:
        parts = _audit_dead_parts(store, wm, n, torch.arange(n, device=dev))
        flat = [torch.cat(x) for x in zip(*parts)]
        audit = dict(gc_watermark=wm, **_gc_stats(*flat, wm, pin_ts))
        ev = _take_events(*flat, cap)
    else:
        s = mesh.get_local_rank()
        parts = _audit_dead_parts(local_store(store), wm, n,
                                  torch.tensor([s], device=dev))
        stats = _gc_stats(*[torch.cat(x) for x in zip(*parts)], wm, pin_ts)
        mine = list(stats.values())
        for part in parts:                  # per level: count + events
            mine += [isum(part[3]), *_take_events(*part, cap)]
        rows = gather_many(mine, mesh)      # each [n, ...]
        audit = {"gc_watermark": wm}
        for k, v in zip(stats, rows):
            audit[k] = (v.max() if k == "gc_delay_max"
                        else v.sum(0, dtype=torch.int32))
        # level-major, rank-minor: the logical flat order
        levels = [rows[len(stats) + 4 * i: len(stats) + 4 * i + 4]
                  for i in range(len(parts))]
        slot = torch.arange(cap, device=dev)[None, :]
        dead = torch.cat([(slot < cnt[:, None]).reshape(-1)
                          for cnt, *_ in levels])
        ev = _take_events(*(torch.cat([lv[j].reshape(-1) for lv in levels])
                            for j in (1, 2, 3)), dead, cap)
    audit.update(gc_event_rec=ev[0], gc_event_begin=ev[1],
                 gc_event_end=ev[2])
    new_store, evicted = gc_sharded(store, wm)
    return new_store, evicted, audit


# ---------------------------------------------------------------------------
# Snapshot reads: mvcc_resolve over the ring in place (or mvcc_resolve_paged
# over the slab), then the spill fall-through through mvcc_resolve_masked
# over the pool in place, the primary's result passed in as its prior.
# ---------------------------------------------------------------------------
def gather_windows_sharded(store: ShardedVersionStore,
                           records: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(begin [B, K], end [B, K], payload [B, K, D]) primary windows. For
    a paged store they are materialised through the page table (K =
    MaxP * S, unmapped pages give empty slots) — a diagnostic path; reads
    go through ``mvcc_resolve_paged``. On a mesh each rank gathers the
    reads it owns (zeros elsewhere) and one all-reduce SUM merges them."""
    n = store.n_shards
    rec = records.to(torch.int32).clamp(min=0).long()
    shard = rec % n
    # an id past the store reads its shard's last row, as the
    # reference's clamped gathers do
    loc = torch.div(rec, n, rounding_mode="floor").clamp(
        max=store.records_per_shard - 1)
    on_mesh = store_mesh(store)
    if on_mesh is None:
        return _gather_rows(store, shard, loc)
    s = on_mesh.get_local_rank()
    owned = shard == s
    b, e, p = _gather_rows(local_store(store), torch.zeros_like(shard), loc)
    b, e = (torch.where(owned[:, None], x, 0) for x in (b, e))
    p = torch.where(owned[:, None, None], p, 0)
    return _merge_windows(b, e, p, on_mesh)


def _gather_rows(store: ShardedVersionStore, shard: torch.Tensor,
                 loc: torch.Tensor):
    if store.paged:
        p = store.pages
        pt = p.page_table[shard, loc]                          # [B, MaxP]
        safe = pt.clamp(min=0).long()
        sh = shard[:, None]
        return mask_gathered_windows(pt, p.begin[sh, safe], p.end[sh, safe],
                                     p.payload[sh, safe])
    r = store.rings
    return r.begin[shard, loc], r.end[shard, loc], r.payload[shard, loc]


def _merge_windows(b, e, p, mesh):
    """Sum the ranks' owned windows (each read has one owner)."""
    return all_reduce(b, mesh), all_reduce(e, mesh), all_reduce(p, mesh)


def _resolve_two_level(prim_s, spill_s: Optional[SpillPool],
                       rows: torch.Tensor, want: torch.Tensor,
                       ts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary resolve with the spill fall-through: a version leaves the
    primary exactly when it moves to spill and [begin, end) windows
    partition a record's timeline, so at most one level holds the
    version visible at ``ts`` and combining is a select. ``rows`` are the
    reads' shard-local record ids clamped to [0, Rl - 1], ``want`` the
    same ids unclamped (the spill pool's owner test), as in the
    reference. The primary is read in place: a dense ring's rows through
    ``mvcc_resolve(rows=)``, a page slab through its page table's rows
    and ``mvcc_resolve_paged(rows=)``; the spill bucket is read in place
    by ``mvcc_resolve_masked``, which takes the primary's result as its
    prior and makes the select: two launches a shard, no copy."""
    if isinstance(prim_s, PageSlab):
        vals, found = ops.mvcc_resolve_paged(prim_s.page_table, prim_s.begin,
                                             prim_s.end, prim_s.payload, ts,
                                             rows=rows)
    else:
        vals, found = ops.mvcc_resolve(prim_s.begin, prim_s.end,
                                       prim_s.payload, ts, rows=rows)
    if spill_s is None:
        return vals, found
    return ops.mvcc_resolve_masked(spill_s.begin, spill_s.end, spill_s.rec,
                                   want, spill_s.payload, ts, in_place=True,
                                   prior=(vals, found))


def resolve_sharded(store: ShardedVersionStore, records: torch.Tensor,
                    ts: torch.Tensor, mesh=None, axis: str = "cc"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve ``records`` [B] at snapshot timestamps ``ts`` [B] through
    the kernels, primary level then spill, once per shard; results merge
    by ownership. An id past the store reads its shard's last row and a
    negative one row 0, as the reference's clamped gathers do; the spill
    pool's owner test takes the id unclamped above, so it never matches
    there. Returns (vals [B, D], found [B]).

    On a mesh every rank resolves every read against its own shard (the
    reads are replicated) and one all-reduce SUM of (vals, found as an
    int) merges them: each read has exactly one owner, so the sum is the
    reference's ``psum`` select."""
    n, last = store.n_shards, store.records_per_shard - 1
    records = records.to(torch.int32)
    ts = ts.to(torch.int32).contiguous()
    if n == 1:
        local = records.clamp(min=0).contiguous()
        return _resolve_two_level(_ring0(store), _take_spill(store, 0),
                                  local.clamp(max=last), local, ts)
    # a read's shard-local id is the same for every shard: a shard that
    # does not own the read resolves it too, and the merge drops that
    # result
    owner = records % n
    local = torch.div(records, n, rounding_mode="floor")
    rows = local.clamp(0, last)

    def one_shard(s, prim, spill):
        owned = owner == s
        v_s, f_s = _resolve_two_level(prim, spill, rows, local, ts)
        return torch.where(owned[:, None], v_s, 0), owned & f_s

    on_mesh = store_mesh(store)
    if on_mesh is not None:
        _, (vals, found) = shard_map(
            lambda s, loc: (None, one_shard(s, _take_shard(loc, 0),
                                            _take_spill(loc, 0))),
            on_mesh, store)
        both = all_reduce(torch.cat([vals, found.to(vals.dtype)[:, None]],
                                    1), on_mesh)
        return both[:, :-1], both[:, -1] > 0
    vals = found = None
    for s in range(n):
        v_s, f_s = one_shard(s, _take_shard(store, s), _take_spill(store, s))
        # each read has exactly one owner: the sum is a select
        vals = v_s if vals is None else vals + v_s
        found = f_s if found is None else found | f_s
    return vals, found
