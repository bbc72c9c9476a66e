"""MVCC version-visibility resolution + payload select: CUDA kernels and
their plain PyTorch versions.

The port of ``repro.kernels.mvcc_resolve`` (the Pallas kernels
``mvcc_resolve``, ``mvcc_resolve_masked`` and ``mvcc_resolve_paged``).
The first two take their candidates in one of two forms. The windows
form is the Pallas kernels' interface, one pre-gathered window per read:

    begin [B, K] i32   version begin timestamps (garbage slots: INT32_MAX)
    end   [B, K] i32   version end timestamps   (open versions: INT32_MAX)
    data  [B, K, D]    payloads, int32 or float32
    ts    [B]    i32   reader timestamps

and gives back (vals [B, D] of data's dtype, found [B] bool). The masked
variant adds ``rec`` [B, K] and ``want`` [B]: slot (i, k) is a candidate
only when ``rec[i, k] == want[i]`` (the spill pool's shared buckets; pad
slots carry rec = -1).

The in-place form reads the store where it lies, with no window copy:

* ``mvcc_resolve(begin, end, data, ts, rows=rows)``: begin/end [R, K]
  and data [R, K, D] are a ring's arrays and read i's window is row
  ``rows[i]`` [B]; a row outside [0, R) gives found = False and zeros.
* ``mvcc_resolve_masked(begin, end, rec, want, data, ts, in_place=True,
  prior=None)``: begin/end/rec [NB, S] and data [NB, S, D] are a spill
  pool and read i's bucket is ``max(want[i], 0) % NB``
  (``store/spill.py::spill_buckets_for``'s rule). With ``prior = (vals
  [B, D], found [B])`` from the primary level, a read whose prior found
  its version returns the prior's values and loads nothing of its
  bucket: the result is ``where(prior_found, prior_vals, s_vals)``,
  ``prior_found | s_found``, the two-level combine in one launch.

The paged variant reads the page slab in place, through page-table
rows:

    page_rows [B, MaxP] i32   page ids of each read's record (-1 = unmapped)
    begin/end [P, S]    i32   the page slab
    data      [P, S, D]       slab payloads
    ts        [B]       i32

read i's candidates are the S slots of every mapped page of its row; an
entry outside [0, P) (-1 among them) is unmapped: it contributes nothing
and loads nothing. That is its windows form, the Pallas kernel's
interface. Its in-place form reads the page table where it lies too:

* ``mvcc_resolve_paged(page_table, begin, end, data, ts, rows=rows)``:
  ``page_table`` [R, MaxP] is the slab's own table and read i's pages
  are ``page_table[rows[i], :]``; a row outside [0, R) gives found =
  False and zeros.

Tie rule: like the Pallas kernels (``repro/kernels/mvcc_resolve.py:69-73``)
both the CUDA kernels and the plain versions SUM the payloads of every
visible slot tied at the largest begin (a consistent store has exactly
one), not the first one as ``repro/kernels/ref.py`` does.

The wrappers take the plain version only for CPU tensors. For CUDA
tensors they launch the kernel (``csrc/mvcc_resolve.cu``, built on first
use by ``_build``) or raise; each launch adds one to ``LAUNCHES[name]``
and to ``LAUNCHES[name + "/rows"]`` (in place) or
``LAUNCHES[name + "/windows"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES, count, reset_launches

NEG_INF = -2 ** 31

_SUFFIX = {torch.int32: "i32", torch.float32: "f32"}

Prior = Optional[Tuple[torch.Tensor, torch.Tensor]]

__all__ = ["LAUNCHES", "reset_launches", "mvcc_resolve",
           "mvcc_resolve_masked", "mvcc_resolve_paged",
           "mvcc_resolve_plain", "mvcc_resolve_masked_plain",
           "mvcc_resolve_paged_plain"]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------
def _select(vis: torch.Tensor, begin: torch.Tensor, data: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    score = torch.where(vis, begin, NEG_INF)
    best = score.max(dim=1).values
    sel = vis & (score == best[:, None])
    vals = torch.where(sel[..., None], data, 0).sum(1, dtype=data.dtype)
    return vals, best > NEG_INF


def mvcc_resolve_plain(begin: torch.Tensor, end: torch.Tensor,
                       data: torch.Tensor, ts: torch.Tensor,
                       rows: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """With ``rows``: gather each read's ring row, resolve it, and give
    rows outside [0, R) found = False and zeros."""
    if rows is not None:
        inside = (rows >= 0) & (rows < begin.shape[0])
        safe = torch.where(inside, rows, 0).long()
        vals, found = mvcc_resolve_plain(begin[safe], end[safe], data[safe],
                                         ts)
        return torch.where(inside[:, None], vals, 0), found & inside
    t = ts[:, None]
    return _select((begin <= t) & (t < end), begin, data)


def mvcc_resolve_masked_plain(begin: torch.Tensor, end: torch.Tensor,
                              rec: torch.Tensor, want: torch.Tensor,
                              data: torch.Tensor, ts: torch.Tensor,
                              in_place: bool = False, prior: Prior = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``in_place``: gather each read's bucket ``max(want, 0) % NB`` of
    the pool, resolve it, then select the prior where it found one."""
    if in_place:
        bkt = (want.clamp(min=0) % begin.shape[0]).long()
        vals, found = mvcc_resolve_masked_plain(begin[bkt], end[bkt],
                                                rec[bkt], want, data[bkt],
                                                ts)
        if prior is None:
            return vals, found
        p_vals, p_found = prior
        return torch.where(p_found[:, None], p_vals, vals), p_found | found
    t = ts[:, None]
    vis = (begin <= t) & (t < end) & (rec == want[:, None])
    return _select(vis, begin, data)


def mvcc_resolve_paged_plain(page_rows: torch.Tensor, begin: torch.Tensor,
                             end: torch.Tensor, data: torch.Tensor,
                             ts: torch.Tensor,
                             rows: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each read's pages into a [B, MaxP*S] window (unmapped pages'
    slots emptied: begin = end = INF, payload 0), then the dense select.
    With ``rows``: ``page_rows`` is the page table; gather the reads'
    table rows, resolve them, and give rows outside [0, R) found = False
    and zeros."""
    if rows is not None:
        inside = (rows >= 0) & (rows < page_rows.shape[0])
        safe = torch.where(inside, rows, 0).long()
        vals, found = mvcc_resolve_paged_plain(page_rows[safe], begin, end,
                                               data, ts)
        return torch.where(inside[:, None], vals, 0), found & inside
    B, max_pages = page_rows.shape
    P, S = begin.shape
    mapped = (page_rows >= 0) & (page_rows < P)
    safe = torch.where(mapped, page_rows, 0).long()
    mapped = mapped[..., None]                            # [B, MaxP, 1]
    inf = 2 ** 31 - 1
    w_begin = torch.where(mapped, begin[safe], inf).reshape(B, max_pages * S)
    w_end = torch.where(mapped, end[safe], inf).reshape(B, max_pages * S)
    w_data = torch.where(mapped[..., None], data[safe], 0).reshape(
        B, max_pages * S, -1)
    return mvcc_resolve_plain(w_begin, w_end, w_data, ts)


# ---------------------------------------------------------------------------
# Wrappers: checks, then the plain version (CPU) or the kernel (CUDA)
# ---------------------------------------------------------------------------
def _check(begin, end, data, ts, rec=None, want=None, rows=None,
           in_place=False, prior: Prior = None) -> torch.device:
    """Shapes, types and one device for either form (``in_place`` or
    ``rows`` given: [R, K] arrays read by row; else one window a read)."""
    if begin.dim() != 2 or data.dim() != 3 or ts.dim() != 1:
        raise ValueError("expected begin/end [R, K], data [R, K, D], "
                         "ts [B]")
    R, K = begin.shape
    B, D = ts.shape[0], data.shape[2]
    by_row = in_place or rows is not None
    if (tuple(end.shape) != (R, K) or tuple(data.shape[:2]) != (R, K)
            or (not by_row and R != B)):
        raise ValueError(f"shape mismatch: begin {tuple(begin.shape)}, end "
                         f"{tuple(end.shape)}, data {tuple(data.shape)}, "
                         f"ts {tuple(ts.shape)}")
    if by_row and R == 0:
        raise ValueError("the in-place form needs at least one row")
    ints = [begin, end, ts]
    if rec is not None:
        if tuple(rec.shape) != (R, K) or tuple(want.shape) != (B,):
            raise ValueError("rec must be shaped like begin and want [B]")
        ints += [rec, want]
    if rows is not None:
        if tuple(rows.shape) != (B,):
            raise ValueError("rows must be [B]")
        ints.append(rows)
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("begin/end/ts (and rec/want/rows) must be int32")
    if data.dtype not in _SUFFIX:
        raise TypeError(f"data must be int32 or float32, got {data.dtype}")
    tensors = ints + [data]
    if prior is not None:
        if not in_place:
            raise ValueError("prior needs in_place=True")
        p_vals, p_found = prior
        if (tuple(p_vals.shape) != (B, D) or p_vals.dtype != data.dtype
                or tuple(p_found.shape) != (B,)
                or p_found.dtype != torch.bool):
            raise ValueError("prior must be (vals [B, D] of data's dtype, "
                             "found [B] bool)")
        tensors += [p_vals, p_found]
    dev = begin.device
    if any(x.device != dev for x in tensors):
        raise ValueError("all inputs must be on one device")
    return dev


def _launch(name: str, form: str, inputs, data: torch.Tensor,
            B: int, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``<name>_<dtype>`` of the C library: pointers of ``inputs``
    (None passes a null pointer), then of the outputs vals [B, D] and
    found [B], then B and the int ``dims`` (whose last entry is D), then
    the stream. Counts the launch under ``name`` and ``name/form``."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(x is None or x.is_contiguous() for x in inputs):
        raise ValueError(f"{name}: inputs must be contiguous")
    vals = torch.empty((B, dims[-1]), dtype=data.dtype, device=dev)
    found = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return vals, found
    _build.call("mvcc_resolve", f"{name}_{_SUFFIX[data.dtype]}",
                [ctypes.c_void_p] * (len(inputs) + 2) + [ctypes.c_longlong]
                + [ctypes.c_int] * len(dims),
                [*(None if x is None else x.data_ptr() for x in inputs),
                 vals.data_ptr(), found.data_ptr(), B, *dims], dev)
    count(name, f"{name}/{form}")
    return vals, found


def mvcc_resolve(begin: torch.Tensor, end: torch.Tensor, data: torch.Tensor,
                 ts: torch.Tensor, rows: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snapshot visibility: over pre-gathered windows, or with ``rows``
    over the ring rows ``rows[i]`` in place (see module doc)."""
    dev = _check(begin, end, data, ts, rows=rows)
    if dev.type == "cpu":
        return mvcc_resolve_plain(begin, end, data, ts, rows)
    R, K, D = data.shape
    return _launch("mvcc_resolve", "windows" if rows is None else "rows",
                   (rows, begin, end, data, ts), data, ts.shape[0],
                   (R, K, D))


def mvcc_resolve_masked(begin: torch.Tensor, end: torch.Tensor,
                        rec: torch.Tensor, want: torch.Tensor,
                        data: torch.Tensor, ts: torch.Tensor,
                        in_place: bool = False, prior: Prior = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility over SHARED windows: slot (i, k) counts for read i only
    when ``rec[i, k] == want[i]``. ``in_place``: over read i's bucket of
    the pool, after the ``prior`` level (see module doc)."""
    dev = _check(begin, end, data, ts, rec, want, in_place=in_place,
                 prior=prior)
    if dev.type == "cpu":
        return mvcc_resolve_masked_plain(begin, end, rec, want, data, ts,
                                         in_place, prior)
    R, K, D = data.shape
    p_vals, p_found = (None, None) if prior is None else prior
    return _launch("mvcc_resolve_masked", "rows" if in_place else "windows",
                   (begin, end, rec, want, data, ts, p_vals, p_found), data,
                   ts.shape[0], (R, int(in_place), K, D))


def mvcc_resolve_paged(page_rows: torch.Tensor, begin: torch.Tensor,
                       end: torch.Tensor, data: torch.Tensor,
                       ts: torch.Tensor, rows: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility through the page table: read i's candidates are the
    slots of the mapped pages in ``page_rows[i]``, or with ``rows`` in
    the table row ``page_rows[rows[i]]`` read in place (see module
    doc)."""
    if page_rows.dim() != 2 or begin.dim() != 2 or data.dim() != 3 \
            or ts.dim() != 1:
        raise ValueError("expected page_rows [B, MaxP] (or a page table "
                         "[R, MaxP] with rows), begin/end [P, S], data "
                         "[P, S, D], ts [B]")
    n_rows, max_pages = page_rows.shape
    P, S = begin.shape
    B = ts.shape[0]
    if (tuple(end.shape) != (P, S) or tuple(data.shape[:2]) != (P, S)
            or (rows is None and n_rows != B)):
        raise ValueError(f"shape mismatch: page_rows "
                         f"{tuple(page_rows.shape)}, begin "
                         f"{tuple(begin.shape)}, end {tuple(end.shape)}, "
                         f"data {tuple(data.shape)}, ts {tuple(ts.shape)}")
    if P == 0 or max_pages == 0:
        raise ValueError("the page slab and the table need at least one "
                         "page")
    ints = [page_rows, begin, end, ts]
    if rows is not None:
        if tuple(rows.shape) != (B,):
            raise ValueError("rows must be [B]")
        if n_rows == 0:
            raise ValueError("the in-place form needs at least one row")
        ints.append(rows)
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("page_rows/begin/end/ts (and rows) must be int32")
    if data.dtype not in _SUFFIX:
        raise TypeError(f"data must be int32 or float32, got {data.dtype}")
    if any(x.device != data.device for x in ints):
        raise ValueError("all inputs must be on one device")
    if data.device.type == "cpu":
        return mvcc_resolve_paged_plain(page_rows, begin, end, data, ts,
                                        rows)
    return _launch("mvcc_resolve_paged",
                   "windows" if rows is None else "rows",
                   (rows, page_rows, begin, end, data, ts), data, B,
                   (n_rows, max_pages, P, S, data.shape[2]))
