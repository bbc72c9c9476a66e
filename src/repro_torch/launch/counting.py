"""Roofline accounting (the port of ``repro.launch.counting``).

Two sources, as the reference's:

1. ``dispatch_costs(fn, *args)`` — runs ``fn`` under a
   ``TorchDispatchMode`` and counts every op that reaches the dispatcher:
   the reference's ``jaxpr_costs``. Returns GLOBAL logical flops
   (dot / conv / elementwise / reduce), ``dot_flops`` and an HBM-traffic
   estimate (dot operands / outputs, gather / scatter, elementwise writes,
   reduction reads and writes, the function's inputs and outputs), plus
   ``bytes_fused``: the same without the elementwise and reduction
   traffic (every such chain fused on chip). The reference multiplies
   scan bodies by their trip count; the port has no scan — its layer and
   chunk loops run in Python, and autograd's backward and
   ``torch.utils.checkpoint``'s recompute reach the dispatcher as ops of
   their own, so nothing is multiplied by hand. On ``DTensor``s the mode
   sees each op once, at its global shapes (DTensor's local ops and
   collectives run below it), so the counts are global, as the
   reference's.

2. ``collective_costs(...)`` — the reference's ``hlo_collectives``: the
   collectives DTensor issued while a ``CollectiveCounter`` (a
   ``CommDebugMode``) was active, under the reference's bytes-moved model
   (ring algorithms, per device): all-gather, all-to-all and permute move
   the bytes of their result; all-reduce 2 x its result; reduce-scatter
   its result x (group - 1).

The ops map to the reference's categories (``counting.py:45-60``):

* dots — ``aten.mm``, ``bmm``, ``addmm``, ``baddbmm`` (the einsums,
  ``@`` and ``linear`` reach them): ``2 * batch * m * n * k`` flops;
  operands and output in bytes. A ``torch.einsum`` that contracts
  nothing (an outer or batched broadcast product) reaches ``aten.mul``;
  ``jnp.einsum`` makes a ``dot_general`` of it, so inside an einsum a
  ``mul`` counts as a dot with ``k = 1`` (2 flops an output element).
  Its gradient is two more ``mul``s, which autograd issues outside any
  einsum: they count as elementwise, where the reference's transposed
  ``dot_general``s count as dots (the SSM families' train steps count
  those dots below the reference's);
* conv — ``aten.convolution``: ``2 * out * (kernel spatial x in-ch)``;
* elementwise — every op tagged ``torch.Tag.pointwise`` plus the
  cumulative ops: one flop an output element, one output write;
* reduce — sums, means, max / min, arg max / min, logsumexp, norms:
  flops = the largest input's elements, inputs and outputs in bytes;
  ``_softmax`` / ``_log_softmax`` count as the five ops XLA sees (max,
  subtract, exp, sum, divide or log);
* gather — ``index``, ``index_select``, ``gather``, ``embedding``:
  2 x the output's bytes; scatter — ``index_put``, ``scatter(_add)``,
  ``index_add``, the embedding's backward: 2 x the update's bytes;
* sort — ``n log2 n`` flops, 4 x the input's bytes;
* the attention kernels' operators (``torch.ops.repro_torch.*``), which a
  dispatch mode sees as one op each, by their formulas
  (``KERNEL_COSTS``), the counts ``chip_smoke.py``'s bounds use:
  ``flash_attention_causal`` does ``4 Dh`` flops a visible (query head,
  key <= query) pair, ``B KvH G S (S + 1) / 2`` pairs, and moves q, out,
  k and v once; its backward ``10 Dh`` flops a pair (S and dP
  recomputed, then dv, dk, dq) and moves q, k, v, out, dout, dq, dk and
  dv once; ``decode_attention`` ``4 Dh`` flops a (query head, key) over
  the whole cache (a walk cannot read ``kv_len`` without a host join,
  and a fake one has no value) and moves q, out, K and V once. All of
  a kernel's flops are dot flops.

Everything else — views, copies and casts (``convert_element_type``
counts nothing in the reference either), factories, ``topk`` — counts
nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten


def _nbytes(x) -> int:
    if not isinstance(x, torch.Tensor):
        return 0
    return math.prod(x.shape) * x.element_size()


def _nelems(x) -> int:
    return math.prod(x.shape) if isinstance(x, torch.Tensor) else 0


def _tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _dot_flops(func, args) -> int:
    """2 * batch * m * n * k of a matrix product (bias terms aside)."""
    if func in (aten.addmm.default, aten.baddbmm.default):
        args = args[1:]
    a, b = args[0], args[1]
    if a.dim() == 2:
        (m, k), n = a.shape, b.shape[1]
        return 2 * m * n * k
    batch, m, k = a.shape
    return 2 * batch * m * b.shape[2] * k


_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
         aten.baddbmm.default}
_CUMULATIVE = {aten.cumsum.default, aten.logcumsumexp.default,
               aten.cummax.default, aten.cummin.default,
               aten.cumprod.default}
_REDUCE = {aten.sum.default, aten.sum.dim_IntList, aten.mean.default,
           aten.mean.dim, aten.amax.default, aten.amin.default,
           aten.max.default, aten.min.default, aten.max.dim, aten.min.dim,
           aten.argmax.default, aten.argmin.default, aten.prod.default,
           aten.prod.dim_int, aten.logsumexp.default, aten.any.default,
           aten.any.dim, aten.all.default, aten.all.dim,
           aten.linalg_vector_norm.default, aten.var_mean.correction,
           aten.var.correction}
_SOFTMAX = {aten._softmax.default, aten._log_softmax.default,
            aten._softmax_backward_data.default,
            aten._log_softmax_backward_data.default}
_GATHER = {aten.index.Tensor, aten.index_select.default,
           aten.gather.default, aten.embedding.default}
_SCATTER = {aten.index_put.default, aten.index_put_.default,
            aten._index_put_impl_.default, aten.scatter.src,
            aten.scatter_.src, aten.scatter.value, aten.scatter_.value,
            aten.scatter_add.default, aten.scatter_add_.default,
            aten.index_add.default, aten.index_add_.default,
            aten.embedding_dense_backward.default,
            aten.index_fill.int_Scalar, aten.index_fill_.int_Scalar}
_SORT = {aten.sort.default, aten.sort.stable}


def flash_cost(q, k, v) -> Dict[str, float]:
    """``flash_attention_causal`` at q [B, S, KvH, G, Dh]: 4 Dh flops a
    visible pair; q, out, k and v moved once."""
    b, s, kvh, g, dh = q.shape
    flops = 4 * b * kvh * g * dh * s * (s + 1) // 2
    return {"flops": flops, "bytes": 2 * _nbytes(q) + _nbytes(k)
            + _nbytes(v)}


def flash_bwd_cost(q, k, v, out, dout) -> Dict[str, float]:
    """Its backward: 10 Dh flops a visible pair; q, k, v, out and dout
    read once, dq, dk and dv written once."""
    b, s, kvh, g, dh = q.shape
    flops = 10 * b * kvh * g * dh * s * (s + 1) // 2
    return {"flops": flops, "bytes": 4 * _nbytes(q) + 2 * _nbytes(k)
            + 2 * _nbytes(v)}


def decode_cost(q, k, v, kv_len) -> Dict[str, float]:
    """``decode_attention`` at q [B, KvH, G, Dh] over a [B, T, KvH, Dh]
    cache taken whole: 4 Dh flops a (query head, key); q, out, K, V and
    kv_len moved once."""
    b, kvh, g, dh = q.shape
    flops = 4 * b * k.shape[1] * kvh * g * dh
    return {"flops": flops, "bytes": 2 * _nbytes(q) + _nbytes(k)
            + _nbytes(v) + _nbytes(kv_len)}


KERNEL_COSTS = {
    "repro_torch::flash_attention_causal": flash_cost,
    "repro_torch::flash_attention_causal_bwd": flash_bwd_cost,
    "repro_torch::decode_attention": decode_cost,
}


class CostMode(TorchDispatchMode):
    """Counts flops / dot_flops / bytes / bytes_fused of every op it sees
    (see the module doc); ``kernels`` counts the attention operators'
    calls by name."""

    def __init__(self):
        super().__init__()
        self.acc = {"flops": 0.0, "dot_flops": 0.0, "bytes": 0.0,
                    "bytes_fused": 0.0}
        self.kernels: Dict[str, int] = {}
        self.in_einsum = 0

    def _add(self, flops=0, dot=0, nbytes=0, fused=True):
        self.acc["flops"] += flops
        self.acc["dot_flops"] += dot
        self.acc["bytes"] += nbytes
        if fused:
            self.acc["bytes_fused"] += nbytes

    def count(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        if name in KERNEL_COSTS:
            c = KERNEL_COSTS[name](*args, **kwargs)
            self._add(c["flops"], c["flops"], c["bytes"])
            self.kernels[name] = self.kernels.get(name, 0) + 1
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func == aten.mul.Tensor and self.in_einsum and \
                all(isinstance(a, torch.Tensor) for a in args[:2]):
            f = 2 * _nelems(outs[0])
            self._add(f, f, sum(map(_nbytes, ins)) + _nbytes(outs[0]))
        elif func in _DOTS:
            f = _dot_flops(func, args)
            self._add(f, f, sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        elif func == aten.convolution.default:
            w = args[1]
            f = 2 * _nelems(outs[0]) * math.prod(w.shape[1:])
            self._add(f, 0, sum(map(_nbytes, ins)) + _nbytes(outs[0]))
        elif func in _SOFTMAX:
            big = max(map(_nelems, ins), default=0)
            self._add(5 * big, 0, sum(map(_nbytes, ins))
                      + sum(map(_nbytes, outs)), fused=False)
        elif func in _REDUCE:
            big = max(map(_nelems, ins), default=0)
            self._add(big, 0, sum(map(_nbytes, ins))
                      + sum(map(_nbytes, outs)), fused=False)
        elif torch.Tag.pointwise in func.tags or func in _CUMULATIVE:
            if outs:
                self._add(_nelems(outs[0]), 0, _nbytes(outs[0]),
                          fused=False)
        elif func in _GATHER:
            self._add(0, 0, 2 * sum(map(_nbytes, outs)))
        elif func in _SCATTER:
            # the update: the last tensor input, as the reference's last
            # invar (the gradient for the embedding's backward)
            upd = args[0] if func == aten.embedding_dense_backward.default \
                else ins[-1]
            self._add(0, 0, 2 * _nbytes(upd))
        elif func in _SORT:
            big = _nelems(args[0])
            self._add(big * max(1, int(math.log2(max(big, 2)))), 0,
                      4 * _nbytes(args[0]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count(func, args, kwargs, out)
        return out


class _EinsumMarks(TorchFunctionMode):
    """Marks the dispatches a ``torch.einsum`` call makes (``CostMode.
    in_einsum``)."""

    def __init__(self, cost: CostMode):
        super().__init__()
        self.cost = cost

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.einsum:
            return func(*args, **kwargs)
        self.cost.in_einsum += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.cost.in_einsum -= 1


def dispatch_costs(fn, *args) -> Dict[str, Any]:
    """Runs ``fn(*args)`` and returns ``{"flops", "dot_flops", "bytes",
    "bytes_fused", "kernels"}`` of everything it dispatched, the bytes of
    ``args`` and of the result included once (the reference's io
    bytes). ``fn`` runs for real: pass fake tensors (``FakeTensorMode``)
    or DTensors over fake local shards for a dry count, real ones for a
    live one."""
    mode = CostMode()
    with mode, _EinsumMarks(mode):
        out = fn(*args)
    acc = dict(mode.acc)
    io = sum(map(_nbytes, _tensors(args))) + sum(map(_nbytes,
                                                     _tensors(out)))
    acc["bytes"] += io
    acc["bytes_fused"] += io
    acc["kernels"] = dict(mode.kernels)
    return acc


# ---------------------------------------------------------------------------
# 2. collectives
# ---------------------------------------------------------------------------
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def _collective_kind(name: str):
    if "all_gather" in name:
        return "all-gather"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_reduce" in name:
        return "all-reduce"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if "permute" in name:
        return "collective-permute"
    return None


def _group_size(func, args) -> int:
    """The collective's group size: its named group's (the last string
    argument), else the int before it (all-gather, reduce-scatter)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if names:
        try:
            return _resolve_process_group(names[-1]).size()
        except (RuntimeError, ValueError, KeyError):
            pass
    ints = [a for a in args[1:] if isinstance(a, int)
            and not isinstance(a, bool)]
    return ints[-1] if ints else 1


def _make_collective_counter():
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveCounter(CommDebugMode):
        """``CommDebugMode`` that also records each collective's kind,
        result bytes and group size (``records``)."""

        def __init__(self):
            super().__init__()
            self.records: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or isinstance(
                    func, torch._ops.HigherOrderOperator):
                return out
            kind = _collective_kind(func._schema.name)
            if kind is not None and "wait" not in func._schema.name:
                self.records.append((kind, sum(map(_nbytes, _tensors(out))),
                                     _group_size(func, args)))
            return out

    return CollectiveCounter()


def collective_counter():
    """A fresh ``CollectiveCounter``: enter it OUTSIDE a ``CostMode`` (so
    the cost mode sees DTensor ops at their global shapes and the counter
    sees the collectives DTensor issues below them)."""
    return _make_collective_counter()


def collective_costs(records) -> Dict[str, Any]:
    """Collective traffic per device from ``(kind, result bytes, group)``
    records (a ``CollectiveCounter``'s ``records``), under the
    reference's bytes-moved model: all-gather / all-to-all / permute ->
    result bytes; all-reduce -> 2 x result; reduce-scatter -> result x
    (group - 1). A collective over a group of one rank (DTensor issues
    them on a (1, 1) mesh) moves nothing and is not counted."""
    stats = dict.fromkeys(_KINDS, 0.0)
    records = [r for r in records if r[2] > 1]   # one rank moves nothing
    for kind, rb, group in records:
        if kind == "all-reduce":
            moved = 2 * rb
        elif kind == "reduce-scatter":
            moved = rb * max(group - 1, 1)
        else:
            moved = rb
        stats[kind] += moved
    out: Dict[str, Any] = {k: float(v) for k, v in stats.items()}
    out["count"] = len(records)
    out["total_bytes"] = float(sum(stats.values()))
    return out
