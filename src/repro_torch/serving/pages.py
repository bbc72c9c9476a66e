"""MVCC paged KV-cache store — the port of ``repro.serving.pages``.

Records    = KV pages; a page is immutable once full.
Write-set  = the (slot, page, offset) a decode step appends to, planned
             by the scheduler (CC phase) before the model step runs.
Read-set   = each sequence's page table; prefix-shared pages have many
             readers, and readers never write page state.
GC         = Condition 3, in the scheduler (``repro_torch.serving.
             scheduler``).

Layout: ``pages`` [L, P, page_size, 2, KvH, Dh], ``page_table`` [S, MaxP]
int32 (page id, -1 = unmapped), ``seq_len`` [S] int32.

Translation notes: the reference's updates are functional; here the
cache is updated IN PLACE (``append_kv`` and the prefill's page writes),
because at smollm-360m's serving defaults it holds 32 x 512 x 16 x 2 x
5 x 64 bf16 = 335 MB and a copy per layer would dominate the step. The
tensor behind ``pages`` holds two more pages: page P is the sink of the
reference's ``mode="drop"`` (inactive slots append there, its contents
are garbage and never read), page P + 1 stays zero and stands in for
every unmapped page table entry in ``gather_kv``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PagedKV:
    store: torch.Tensor       # [L, P + 2, page, 2, KvH, Dh]: P pages, sink,
                              # zero page
    page_table: torch.Tensor  # [S, MaxP] int32 (page id, -1 = unmapped)
    seq_len: torch.Tensor     # [S] int32 tokens stored per slot

    @property
    def pages(self) -> torch.Tensor:
        """The [L, P, page, 2, KvH, Dh] pages (a view of ``store``)."""
        return self.store[:, :-2]

    @property
    def num_pages(self) -> int:
        return self.store.shape[1] - 2

    @property
    def page_size(self) -> int:
        return self.store.shape[2]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]


def init_paged_kv(layers: int, num_pages: int, page_size: int, slots: int,
                  max_pages_per_seq: int, kvh: int, dh: int,
                  dtype=torch.bfloat16, device=None) -> PagedKV:
    return PagedKV(
        store=torch.zeros((layers, num_pages + 2, page_size, 2, kvh, dh),
                          dtype=dtype, device=device),
        page_table=torch.full((slots, max_pages_per_seq), -1,
                              dtype=torch.int32, device=device),
        seq_len=torch.zeros((slots,), dtype=torch.int32, device=device))


def append_kv(kv: PagedKV, layer: int, k: torch.Tensor, v: torch.Tensor,
              slot_pages: torch.Tensor, offsets: torch.Tensor,
              active: torch.Tensor) -> PagedKV:
    """Write one new token's K/V into the planned (page, offset) of every
    active slot, in place; inactive slots write to the sink page.

    k, v: [S, KvH, Dh]; slot_pages/offsets: [S] plan arrays; active: [S].
    The plan guarantees distinct (page, offset) per active slot — no
    write-write conflicts by construction (CC phase property).
    """
    page = torch.where(active, slot_pages, kv.num_pages).long()
    upd = torch.stack([k, v], dim=1).to(kv.store.dtype)   # [S, 2, KvH, Dh]
    kv.store[layer, page, offsets.long()] = upd
    return kv


def write_pages(kv: PagedKV, layer: int, page_ids: torch.Tensor,
                upd: torch.Tensor) -> PagedKV:
    """Set whole pages of ``layer`` in place: ``upd`` [n, page, 2, KvH,
    Dh] into ``page_ids`` [n] (distinct, mapped)."""
    kv.store[layer, page_ids.long()] = upd.to(kv.store.dtype)
    return kv


def gather_kv(kv: PagedKV, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot KV streams (k, v), each [S, MaxP * page, KvH, Dh] and
    contiguous, through the page table; unmapped pages read as zeros."""
    idx = torch.where(kv.page_table >= 0, kv.page_table,
                      kv.num_pages + 1).long()              # [S, MaxP]
    s, mp = idx.shape
    lay = kv.store[layer]                                   # [P+2, ps, 2, ...]
    k = lay[:, :, 0][idx]                                   # [S, MaxP, ps, ...]
    v = lay[:, :, 1][idx]
    shape = (s, mp * kv.page_size) + tuple(k.shape[3:])
    return k.reshape(shape), v.reshape(shape)
