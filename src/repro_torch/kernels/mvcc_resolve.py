"""MVCC version-visibility resolution + payload select: CUDA kernels and
their plain PyTorch versions.

The port of ``repro.kernels.mvcc_resolve`` (the Pallas kernels
``mvcc_resolve``, ``mvcc_resolve_masked`` and ``mvcc_resolve_paged``).
Callers of the first two pre-gather the candidate windows per read:

    begin [B, K] i32   version begin timestamps (garbage slots: INT32_MAX)
    end   [B, K] i32   version end timestamps   (open versions: INT32_MAX)
    data  [B, K, D]    payloads, int32 or float32
    ts    [B]    i32   reader timestamps

and get back (vals [B, D] of data's dtype, found [B] bool). The masked
variant adds ``rec`` [B, K] and ``want`` [B]: slot (i, k) is a candidate
only when ``rec[i, k] == want[i]`` (the spill pool's shared buckets; pad
slots carry rec = -1). The paged variant reads the windows in place,
through the reads' page-table rows:

    page_rows [B, MaxP] i32   page ids of each read's record (-1 = unmapped)
    begin/end [P, S]    i32   the page slab
    data      [P, S, D]       slab payloads
    ts        [B]       i32

read i's candidates are the S slots of every mapped page of its row; an
unmapped entry contributes nothing and loads nothing.

Tie rule: like the Pallas kernels (``repro/kernels/mvcc_resolve.py:69-73``)
both the CUDA kernels and the plain versions SUM the payloads of every
visible slot tied at the largest begin (a consistent store has exactly
one), not the first one as ``repro/kernels/ref.py`` does.

The wrappers take the plain version only for CPU tensors. For CUDA
tensors they launch the kernel (``csrc/mvcc_resolve.cu``, built on first
use by ``_build``) or raise; each launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES, reset_launches

NEG_INF = -2 ** 31

_SUFFIX = {torch.int32: "i32", torch.float32: "f32"}

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
                       data: torch.Tensor, ts: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    t = ts[:, None]
    return _select((begin <= t) & (t < end), begin, data)


def mvcc_resolve_masked_plain(begin: torch.Tensor, end: torch.Tensor,
                              rec: torch.Tensor, want: torch.Tensor,
                              data: torch.Tensor, ts: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    t = ts[:, None]
    vis = (begin <= t) & (t < end) & (rec == want[:, None])
    return _select(vis, begin, data)


def mvcc_resolve_paged_plain(page_rows: torch.Tensor, begin: torch.Tensor,
                             end: torch.Tensor, data: torch.Tensor,
                             ts: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each read's pages into a [B, MaxP*S] window (unmapped pages'
    slots emptied: begin = end = INF, payload 0), then the dense select."""
    B, max_pages = page_rows.shape
    S = begin.shape[1]
    safe = page_rows.clamp(min=0).long()
    mapped = (page_rows >= 0)[..., None]                  # [B, MaxP, 1]
    inf = 2 ** 31 - 1
    w_begin = torch.where(mapped, begin[safe], inf).reshape(B, max_pages * S)
    w_end = torch.where(mapped, end[safe], inf).reshape(B, max_pages * S)
    w_data = torch.where(mapped[..., None], data[safe], 0).reshape(
        B, max_pages * S, -1)
    return mvcc_resolve_plain(w_begin, w_end, w_data, ts)


# ---------------------------------------------------------------------------
# Wrappers: checks, then the plain version (CPU) or the kernel (CUDA)
# ---------------------------------------------------------------------------
def _check(begin, end, data, ts, rec=None, want=None) -> torch.device:
    if begin.dim() != 2 or data.dim() != 3 or ts.dim() != 1:
        raise ValueError("expected begin/end [B, K], data [B, K, D], "
                         "ts [B]")
    B, K = begin.shape
    if (tuple(end.shape) != (B, K) or tuple(data.shape[:2]) != (B, K)
            or ts.shape[0] != B):
        raise ValueError(f"shape mismatch: begin {tuple(begin.shape)}, end "
                         f"{tuple(end.shape)}, data {tuple(data.shape)}, "
                         f"ts {tuple(ts.shape)}")
    ints = [begin, end, ts]
    if rec is not None:
        if tuple(rec.shape) != (B, K) or tuple(want.shape) != (B,):
            raise ValueError("rec must be [B, K] and want [B]")
        ints += [rec, want]
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("begin/end/ts (and rec/want) must be int32")
    if data.dtype not in _SUFFIX:
        raise TypeError(f"data must be int32 or float32, got {data.dtype}")
    dev = begin.device
    if any(x.device != dev for x in ints + [data]):
        raise ValueError("all inputs must be on one device")
    return dev


def _launch(name: str, inputs, data: torch.Tensor, B: int, dims
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``<name>_<dtype>`` of the C library: pointers of ``inputs``,
    then of the outputs vals [B, D] and found [B], then B and the int
    ``dims`` (whose last entry is D), then the stream."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(x.is_contiguous() for x in inputs):
        raise ValueError(f"{name}: inputs must be contiguous")
    vals = torch.empty((B, dims[-1]), dtype=data.dtype, device=dev)
    found = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return vals, found
    _build.call("mvcc_resolve", f"{name}_{_SUFFIX[data.dtype]}",
                [ctypes.c_void_p] * (len(inputs) + 2) + [ctypes.c_longlong]
                + [ctypes.c_int] * len(dims),
                [*(x.data_ptr() for x in inputs), vals.data_ptr(),
                 found.data_ptr(), B, *dims], dev)
    LAUNCHES[name] += 1
    return vals, found


def mvcc_resolve(begin: torch.Tensor, end: torch.Tensor, data: torch.Tensor,
                 ts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snapshot visibility over pre-gathered windows (see module doc)."""
    dev = _check(begin, end, data, ts)
    if dev.type == "cpu":
        return mvcc_resolve_plain(begin, end, data, ts)
    B, K, D = data.shape
    return _launch("mvcc_resolve", (begin, end, data, ts), data, B, (K, D))


def mvcc_resolve_masked(begin: torch.Tensor, end: torch.Tensor,
                        rec: torch.Tensor, want: torch.Tensor,
                        data: torch.Tensor, ts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility over SHARED windows: slot (i, k) counts for read i only
    when ``rec[i, k] == want[i]``."""
    dev = _check(begin, end, data, ts, rec, want)
    if dev.type == "cpu":
        return mvcc_resolve_masked_plain(begin, end, rec, want, data, ts)
    B, K, D = data.shape
    return _launch("mvcc_resolve_masked", (begin, end, rec, want, data, ts),
                   data, B, (K, D))


def mvcc_resolve_paged(page_rows: torch.Tensor, begin: torch.Tensor,
                       end: torch.Tensor, data: torch.Tensor,
                       ts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visibility through the page table: read i's candidates are the
    slots of the mapped pages in ``page_rows[i]`` (see module doc)."""
    if page_rows.dim() != 2 or begin.dim() != 2 or data.dim() != 3 \
            or ts.dim() != 1:
        raise ValueError("expected page_rows [B, MaxP], begin/end [P, S], "
                         "data [P, S, D], ts [B]")
    B, max_pages = page_rows.shape
    P, S = begin.shape
    if (tuple(end.shape) != (P, S) or tuple(data.shape[:2]) != (P, S)
            or ts.shape[0] != B):
        raise ValueError(f"shape mismatch: page_rows "
                         f"{tuple(page_rows.shape)}, begin "
                         f"{tuple(begin.shape)}, end {tuple(end.shape)}, "
                         f"data {tuple(data.shape)}, ts {tuple(ts.shape)}")
    ints = [page_rows, begin, end, ts]
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("page_rows/begin/end/ts must be int32")
    if data.dtype not in _SUFFIX:
        raise TypeError(f"data must be int32 or float32, got {data.dtype}")
    if any(x.device != data.device for x in ints):
        raise ValueError("all inputs must be on one device")
    if data.device.type == "cpu":
        return mvcc_resolve_paged_plain(page_rows, begin, end, data, ts)
    return _launch("mvcc_resolve_paged", (page_rows, begin, end, data, ts),
                   data, B, (max_pages, P, S, data.shape[2]))

