"""Adaptive per-record ring capacity: the K-reassignment policy.

The port of ``repro.store.policy``, kept line for line: it is plain
numpy host code in the reference too, so the port's copy is the same
functions on the same numpy vectors (the engine hands them over in one
device-to-host transfer per sweep).

The spill tier absorbs *transient* live evictions; the policy removes
*persistent* ones by reshaping primary capacity to the workload: at GC
(``BohmEngine.gc_sweep``) boundaries the engine hands the per-record
live-eviction counts (``overflow_by_record`` — overwrites of versions a
registered snapshot pin could still read; dead overwrites are split out
and never reach the policy, see repro_torch/store/ring.py) to ``reassign_k``,
which GROWS hot records' effective ring capacity toward the physical slot
count and SHRINKS pressure-free records toward ``k_min``, preserving the
total slot budget sum(k_eff).

Host-side on purpose: reassignment is control-plane work on [R] integer
vectors at sweep frequency — numpy is the right tool, and keeping it off
the device queue means the policy can never stall a commit.

The pass is a one-shot greedy transfer and a FIXPOINT: hottest records
fill first from the pool of slots donated by pressure-free records, and a
second call with the same pressure vector returns the same assignment
(either every pressured record reached ``k_max`` or every donor reached
``k_min``) — which is what keeps ``gc_sweep`` idempotent.

Two refinements on top of the base pass:

  * ``quantum`` — capacity moves in multiples of a quantum (the paged
    store's ``page_slots``): the pass runs in quantum units with every
    bound rounded CONSERVATIVELY (floors round up), so reassignment is
    a physical page grant/reclaim rather than a logical cap, and all
    the invariants (budget conserved, floor respected, fixpoint) hold
    in quantum units too.
  * ``decay_pressure`` — an EWMA with a configurable half-life over the
    per-sweep live-eviction deltas. Raw cumulative pressure never
    forgets: a record that was hot once holds its peak grant forever
    even after the hot set migrates. With decay, a cooled record's
    pressure halves every ``half_life`` sweeps and eventually truncates
    to zero, at which point it becomes a donor and its pages flow to
    the new hot set (engine knob ``pressure_decay``).
"""
from __future__ import annotations

import numpy as np


def decay_pressure(prev: np.ndarray, delta: np.ndarray,
                   half_life: float) -> np.ndarray:
    """One EWMA step of the policy's pressure input: the accumulated
    pressure halves every ``half_life`` sweeps and this sweep's fresh
    live-eviction counts ``delta`` are added at full weight. Returns a
    float vector — ``reassign_k`` truncates it to integers, so a cooled
    record's pressure reaches exactly zero (donor eligibility) after
    finitely many idle sweeps."""
    if half_life <= 0:
        raise ValueError("pressure half-life must be > 0 sweeps")
    alpha = 0.5 ** (1.0 / float(half_life))
    return np.asarray(prev, np.float64) * alpha + np.asarray(delta,
                                                             np.float64)


def _fill_first(order: np.ndarray, cap: np.ndarray,
                total: int) -> np.ndarray:
    """Allocate ``total`` units over ``cap`` (aligned with ``order``) by
    filling the earliest entries of ``order`` to capacity first."""
    c = cap[order]
    cum = np.cumsum(c)
    out = np.zeros_like(cap)
    out[order] = np.clip(total - (cum - c), 0, c)
    return out


def reassign_k(pressure: np.ndarray, k_eff: np.ndarray, *,
               k_min: int = 1, k_max: int, k_base: int | None = None,
               occupancy: np.ndarray | None = None,
               stable_idle: np.ndarray | None = None,
               budget: int | None = None,
               quantum: int = 1) -> np.ndarray:
    """Deterministic slot transfer from cold records to hot ones.

    ``pressure``  [R] — live-eviction counts (the policy input);
    ``k_eff``    [R] — current per-record capacities;
    ``occupancy`` [R] — live slot count per record AFTER the sweep this
    pass rides on (optional but strongly recommended — the engine always
    passes it).

    Donors are records with zero pressure, restricted to ``stable_idle``
    ones when that mask is given, and they never shrink below
    ``occupancy + 1`` (current retained history + head headroom): a
    record whose ring still holds versions is ACTIVE even if nothing has
    evicted yet, and shrinking it below what it retains would immediately
    evict a reader-visible version — the policy would be manufacturing
    the very pressure it is trying to relieve (measured: donor selection
    on pressure alone cascades one live eviction per warm record through
    the spill pool and the found-rate DROPS).  ``stable_idle`` is the
    hysteresis half of the same lesson: a record idle at ONE sweep is
    often just between writes (at Poisson rates a fifth of an active
    band is momentarily idle), and shrinking it costs a live eviction on
    its next write — the engine passes records idle across two
    consecutive sweeps (fast promotion, slow demotion).

    Two allocation phases, both funded by that pool and both filling
    hottest-first (stable: ties resolve by record id):

      repair   every pressured record is first raised back to ``k_base``
               (the engine passes its original ``ring_slots``), so a
               former donor that shows pressure recovers its baseline
               BEFORE any record grows past it toward ``k_max``;
      grow     leftover donor slots raise the hottest records toward
               ``k_max``.

    Returns the new [R] capacities with ``sum`` unchanged (and verified
    against ``budget`` when given) and every entry in [k_min, k_max].
    The pass is a fixpoint of the (pressure, occupancy) pair: after it,
    either every pressured record sits at its target or every donor sits
    at its floor, so calling it again changes nothing (gc_sweep
    idempotence — reassignment caps only future insertions and cannot
    change occupancy itself).

    ``quantum > 1`` runs the whole pass in units of ``quantum`` slots
    (the paged store's page granularity): ``k_eff`` and ``k_max`` must
    be multiples, every floor rounds UP to the next multiple (so the
    occupancy+1 invariant still holds in slots), and the returned
    capacities stay multiples — a grant or reclaim is then exactly a
    whole-page transfer.
    """
    if k_min < 1:
        raise ValueError("k_min must be >= 1 (0-slot rings cannot commit)")
    if quantum > 1:
        q = int(quantum)
        k_arr = np.asarray(k_eff, np.int64)
        if (k_arr % q).any():
            raise ValueError("k_eff entries must be multiples of quantum")
        if k_max % q:
            raise ValueError("k_max must be a multiple of quantum")
        occ_q = None
        if occupancy is not None:
            # inner floor max(k_min_q, occ_q + 1) must cover the slot
            # floor occ + 1: occ_q + 1 = ceil((occ + 1) / q)
            occ_q = -(-(np.asarray(occupancy, np.int64) + 1) // q) - 1
        out = reassign_k(pressure, k_arr // q,
                         k_min=-(-int(k_min) // q), k_max=int(k_max) // q,
                         k_base=None if k_base is None
                         else -(-int(k_base) // q),
                         occupancy=occ_q, stable_idle=stable_idle,
                         budget=None if budget is None
                         else int(budget) // q)
        return (out.astype(np.int64) * q).astype(np.int32)
    pressure = np.asarray(pressure, np.int64)
    k = np.asarray(k_eff, np.int64).copy()
    if budget is not None and int(k.sum()) > int(budget):
        raise ValueError("k_eff already exceeds the slot budget")

    floor = np.full_like(k, k_min)
    if occupancy is not None:
        floor = np.maximum(floor, np.asarray(occupancy, np.int64) + 1)
    donor = pressure == 0
    if stable_idle is not None:
        donor = donor & np.asarray(stable_idle, bool)
    shrink_cap = np.where(donor, np.maximum(k - floor, 0), 0)
    pool = int(shrink_cap.sum())
    hot = np.argsort(-pressure, kind="stable")

    repair_cap = np.zeros_like(k)
    if k_base is not None:
        repair_cap = np.where(pressure > 0,
                              np.clip(min(k_base, k_max) - k, 0, None), 0)
    t_repair = min(pool, int(repair_cap.sum()))
    grow = _fill_first(hot, repair_cap, t_repair)

    grow_cap = np.where(pressure > 0, np.maximum(k_max - (k + grow), 0), 0)
    t_grow = min(pool - t_repair, int(grow_cap.sum()))
    grow = grow + _fill_first(hot, grow_cap, t_grow)

    total = t_repair + t_grow
    if total == 0:
        return k.astype(np.int32)

    # donors release lowest record id first among the pressure-free
    # (stable argsort of the zero pressures)
    cold = np.argsort(pressure, kind="stable")
    shrink = _fill_first(cold, shrink_cap, total)

    new_k = k + grow - shrink
    assert int(new_k.sum()) == int(k.sum())
    assert new_k.min() >= k_min and new_k.max() <= k_max
    return new_k.astype(np.int32)


def reassign_stats(old_k: np.ndarray, new_k: np.ndarray,
                   quantum: int = 1) -> dict:
    """Host-side summary of one ``reassign_k`` pass — what the policy
    actually moved. The engine records this into the metrics registry
    and attaches it to the ``reassign_k`` trace span, so capacity churn
    is observable without re-deriving it from ring state."""
    old = np.asarray(old_k, np.int64)
    new = np.asarray(new_k, np.int64)
    d = new - old
    return {
        "slots_granted": int(d[d > 0].sum()),
        "slots_reclaimed": int(-d[d < 0].sum()),
        "records_grown": int((d > 0).sum()),
        "records_shrunk": int((d < 0).sum()),
        "quantum": int(quantum),
    }
