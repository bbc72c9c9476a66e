"""Serving engine: execution phase of the two-phase serving architecture.

The port of ``repro.serving.engine``. ``ServeEngine`` owns the step
functions; ALL scheduling decisions (slots, pages, timestamps, prefix
sharing, GC) are made by the ``BohmScheduler`` before a step is
dispatched, so the step functions contain no coordination logic.

Request state lives in a Bohm MVCC record store (``repro_torch.core.
engine.BohmEngine`` with ``state_shards`` logical shards): every serving
step commits one update batch of per-request progress records, and point
lookups (``lookup``, ``progress_view``) are batched through
``run_readonly_batch``, resolved by the ``mvcc_resolve`` and
``mvcc_resolve_masked`` kernels once per shard. A monitor can pin a
snapshot and read a consistent progress view while decode steps keep
committing.

Attention runs through the hand-written kernels: every decode step and
every prefix-hit ``_logits_at`` attends through ``decode_attention``
(over the page table's gathered view of the cache), every prefill
through ``flash_attention_causal``; on CPU tensors both take their plain
versions. The matrix products around them are ``torch.matmul``, as the
reference leaves them to XLA. PyTorch runs eagerly, so there are no
jits; the reference's per-``prompt_len`` compilation has no counterpart.

Supports the dense GQA decoder family (``cfg.attention == "full"``, not
encoder-decoder, not hybrid). An enabled ``PhaseTracer`` times
``serve/prefill``, ``serve/logits_at``, ``serve/decode`` and
``serve/state_flush`` beside the state store's own phases.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import BohmEngine, SnapshotHandle
from repro_torch.core.txn import Workload, make_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.transformer import check_supported, layer_params
from repro_torch.serving import pages as pages_mod
from repro_torch.serving.scheduler import BohmScheduler, Request

# request-state record payload: [seq_len, n_generated, last_token+1, status]
STATE_WORDS = 4
STATE_UNKNOWN, STATE_ACTIVE, STATE_DONE = 0, 1, 2


def make_state_workload() -> Workload:
    """One-branch workload for the request-state store: a blind put of the
    4-word progress row (reads nothing — writes never wait on reads)."""
    def put(vals, args):
        return args[:, None, :], torch.zeros(
            (args.shape[0],), dtype=torch.bool, device=args.device)

    return Workload(name="serve_state", n_read=1, n_write=1,
                    payload_words=STATE_WORDS, branches=(put,))


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 page_size: int = 16, num_pages: int = 512,
                 max_pages_per_seq: int = 64, temperature: float = 0.0,
                 kv_dtype: torch.dtype = torch.bfloat16,
                 max_rids: int = 1024, state_shards: int = 2,
                 registry=None, tracer=None, device: DeviceLike = None):
        """Arguments and defaults as in ``repro.serving.engine.
        ServeEngine``, plus ``device``: default the GPU, which raises
        when there is none; pass ``device="cpu"`` (with parameters on the
        CPU) for the plain PyTorch path. ``params`` are the port's
        (``repro_torch.models.transformer.init_params`` or
        ``params_from_reference``) on that device."""
        check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.temperature = temperature
        self.sched = BohmScheduler(slots=slots, num_pages=num_pages,
                                   page_size=page_size,
                                   max_pages_per_seq=max_pages_per_seq)
        self.kv = pages_mod.init_paged_kv(
            cfg.num_layers, num_pages, page_size, slots, max_pages_per_seq,
            cfg.num_kv_heads, cfg.head_dim, kv_dtype, self.device)
        # MVCC request-state store: one progress record per rid, committed
        # through the full CC -> exec -> commit pipeline each serving step
        # and read back via batched snapshot reads over the logical shards
        self.max_rids = max_rids
        self.state = BohmEngine(max_rids, make_state_workload(),
                                ring_slots=4, n_shards=state_shards,
                                registry=registry, tracer=tracer,
                                device=self.device)
        self.tracer = self.state.tracer
        self.metrics = self.state.metrics
        self._state_dirty: Dict[int, List[int]] = {}
        self.steps = 0

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a)).to(device=self.device,
                                                 dtype=dtype)

    # ------------------------------------------------------------------
    def submit(self, rid: int, prompt: np.ndarray, max_new_tokens: int):
        if not 0 <= rid < self.max_rids:
            raise ValueError(f"rid must be in [0, {self.max_rids})")
        self.sched.submit(Request(rid=rid, prompt=np.asarray(prompt,
                                                             np.int32),
                                  max_new_tokens=max_new_tokens))

    # -- request-state store -------------------------------------------
    def _mark_state(self, req: Request, status: int) -> None:
        last = req.generated[-1] + 1 if req.generated else 0
        self._state_dirty[req.rid] = [
            len(req.prompt) + len(req.generated), len(req.generated),
            last, status]

    def _flush_state(self) -> None:
        """Commit this step's progress rows as fixed-shape update batches
        (pads for idle slots keep the batch shape fixed; more than one
        batch only if rows somehow exceed the slot count)."""
        if not self._state_dirty:
            return
        S = self.sched.slots
        rows = sorted(self._state_dirty.items())
        self._state_dirty.clear()
        for lo in range(0, len(rows), S):
            chunk = rows[lo:lo + S]
            writes = np.full((S, 1), -1, np.int64)
            args = np.zeros((S, STATE_WORDS), np.int64)
            for i, (rid, row) in enumerate(chunk):
                writes[i, 0] = rid
                args[i] = row
            batch = make_batch(np.full((S, 1), -1), writes, np.zeros(S),
                               args, device=self.device)
            self.state.run_batch(batch)

    def lookup(self, rids, ts: Optional[SnapshotHandle] = None
               ) -> Dict[str, np.ndarray]:
        """Batched point lookups of request progress, resolved in one
        ``run_readonly_batch`` snapshot-read step against the sharded
        store (zero bookkeeping writes). ``ts`` may be a pinned
        ``SnapshotHandle`` for a consistent historical view while decode
        steps keep committing. Returns arrays keyed by field."""
        rids = np.asarray(rids, np.int64).reshape(-1)
        if len(rids) and (rids.min() < 0 or rids.max() >= self.max_rids):
            raise ValueError(f"rids must be in [0, {self.max_rids})")
        batch = make_batch(rids[:, None], np.full((len(rids), 1), -1),
                           np.zeros(len(rids)),
                           np.zeros((len(rids), STATE_WORDS)),
                           device=self.device)
        vals, found, _ = self.state.run_readonly_batch(batch, ts)
        rows = vals[:, 0].cpu().numpy()               # [N, STATE_WORDS]
        found = found[:, 0].cpu().numpy()
        return {
            "rid": rids,
            "seq_len": rows[:, 0],
            "n_generated": rows[:, 1],
            "last_token": rows[:, 2] - 1,             # -1 = none yet
            "status": rows[:, 3],
            "known": found & (rows[:, 3] != STATE_UNKNOWN),
        }

    def begin_state_snapshot(self) -> SnapshotHandle:
        """Pin a consistent progress snapshot (holds state-store GC)."""
        return self.state.begin_snapshot()

    def release_state_snapshot(self, handle: SnapshotHandle) -> None:
        self.state.release_snapshot(handle)

    def progress_view(self, ts: Optional[SnapshotHandle] = None,
                      rids=None) -> Dict[str, np.ndarray]:
        """A consistent snapshot of request progress across every rid
        (``lookup`` fields plus ``view_ts``, the timestamp the view is
        pinned at). ``ts`` may be a pinned ``SnapshotHandle`` (from
        ``begin_state_snapshot``) — polled again it returns the same rows
        however many update batches commit in between — or an explicit
        timestamp; ``None`` reads everything committed now."""
        if rids is None:
            rids = np.arange(self.max_rids)
        view = self.lookup(rids, ts)
        if isinstance(ts, SnapshotHandle):
            view_ts = ts.ts
        elif ts is None:
            view_ts = self.state.current_ts()
        else:
            view_ts = int(ts)
        view["view_ts"] = np.asarray(view_ts)
        return view

    def _sync_tables(self) -> None:
        """The scheduler changed page tables / lengths on the host: copy
        them to the device cache."""
        self.kv = pages_mod.PagedKV(
            store=self.kv.store, page_table=self._t(self.sched.page_table),
            seq_len=self._t(self.sched.seq_len))

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Continuous batching loop until all submitted requests finish."""
        next_tok: Dict[int, int] = {}
        tr = self.tracer
        while (self.sched.queue or self.sched.num_active) and \
                max_steps > 0:
            max_steps -= 1
            for req, shared in self.sched.admit():
                pt = self._t(self.sched.page_table[req.slot])
                if shared is None:
                    # execution phase computes the prompt's KV into the
                    # planned placeholder pages
                    with tr.span("serve/prefill",
                                 tokens=len(req.prompt)) as sp:
                        self.kv, logits = _paged_prefill(
                            self.params, self.kv, self._t(req.prompt), pt,
                            req.slot, prompt_len=len(req.prompt),
                            cfg=self.cfg)
                        sp.fence(logits)
                else:
                    # prefix hit: KV already materialised in shared pages;
                    # produce the first token from the last prompt position
                    with tr.span("serve/logits_at") as sp:
                        logits = _logits_at(self.params, self.kv,
                                            self._t(req.prompt[-1:]), pt,
                                            seq_len=len(req.prompt),
                                            cfg=self.cfg)
                        sp.fence(logits)
                tok = int(torch.argmax(logits[-1]))
                next_tok[req.slot] = tok
                req.generated.append(tok)
                self._mark_state(req, STATE_ACTIVE)
                self._sync_tables()
            if not self.sched.num_active:
                continue
            plan = self.sched.plan_step(next_tok)
            if not plan.active.any():
                continue
            self._sync_tables()
            with tr.span("serve/decode",
                         slots=int(plan.active.sum())) as sp:
                logits = _paged_decode_step(
                    self.params, self.kv, self._t(plan.tokens),
                    self._t(plan.slot_pages), self._t(plan.offsets),
                    self._t(plan.positions),
                    self._t(plan.active, torch.bool), cfg=self.cfg)
                sp.fence(logits)
            self.steps += 1
            toks = torch.argmax(logits, dim=-1).cpu().numpy()
            for s, req in enumerate(self.sched.slot_req):
                if req is None or not plan.active[s]:
                    continue
                tok = int(toks[s])
                req.generated.append(tok)
                next_tok[s] = tok
                if len(req.generated) >= req.max_new_tokens:
                    self.sched.complete(s)
                    next_tok.pop(s, None)
                    self._mark_state(req, STATE_DONE)
                else:
                    self._mark_state(req, STATE_ACTIVE)
            with tr.span("serve/state_flush") as sp:
                self._flush_state()
                sp.fence(self.state.store.base)
            self.sched.end_batch()
        return self.sched.finished


# ---------------------------------------------------------------------------
# execution-phase step functions
# ---------------------------------------------------------------------------
def _head(params, x, cfg):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def _attend_paged(p, h, cfg, kv, layer, positions, active):
    """One layer of paged decode attention for all slots. h: [S, 1, D].
    ``decode_attention`` masks each slot at its ``seq_len``; an idle
    slot (``seq_len = 0``) attends to nothing and gets zeros."""
    s = h.shape[0]
    q = (h @ p["attn"]["wq"]).reshape(s, 1, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["attn"]["q_norm"], cfg.norm_eps)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k_all, v_all = pages_mod.gather_kv(kv, layer)     # [S, T, KvH, Dh]
    # head h = kvh * G + g
    out = ops.decode_attention(
        q.reshape(s, cfg.num_kv_heads, -1, cfg.head_dim).to(k_all.dtype),
        k_all, v_all, kv.seq_len).to(q.dtype)
    return out.reshape(s, 1, cfg.q_dim) @ p["attn"]["wo"]


def _kv_proj(p, h, cfg, positions):
    s = h.shape[0]
    k = (h @ p["attn"]["wk"]).reshape(s, -1, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["attn"]["wv"]).reshape(s, -1, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_norm(k, p["attn"]["k_norm"], cfg.norm_eps)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _paged_decode_step(params, kv, tokens, slot_pages, offsets, positions,
                       active, *, cfg: ModelConfig):
    """One token for every active slot against the paged cache (appends
    in place). Returns logits [S, V] in float32."""
    x = params["embed"][tokens.long()][:, None, :]             # [S, 1, D]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        k, v = _kv_proj(lp, h, cfg, positions[:, None])
        kv = pages_mod.append_kv(kv, i, k[:, 0], v[:, 0], slot_pages,
                                 offsets, active)
        x = x + _attend_paged(lp, h, cfg, kv, i, positions, active)
        x = x + ffn_mod.dense_fwd(
            lp["ffn"], rms_norm(x, lp["ffn_norm"], cfg.norm_eps), cfg)
    return _head(params, x[:, 0], cfg)


def _paged_prefill(params, kv, prompt, page_table, slot, *, prompt_len: int,
                   cfg: ModelConfig):
    """Prefill one slot's prompt, writing KV into its planned pages (in
    place). Returns (kv, logits [1, V] of the last position)."""
    ps = kv.page_size
    n_pages = (prompt_len + ps - 1) // ps
    x = params["embed"][prompt.long()][None]                    # [1, L, D]
    positions = torch.arange(prompt_len, device=prompt.device)[None]
    pad = n_pages * ps - prompt_len
    pids = page_table[:n_pages]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        k, v = _kv_proj(lp, h, cfg, positions)
        q = (h @ lp["attn"]["wq"]).reshape(1, prompt_len, cfg.num_heads,
                                           cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, lp["attn"]["q_norm"], cfg.norm_eps)
        q = apply_rope(q, positions, cfg.rope_theta)
        # head h = kvh * G + g
        att = ops.flash_attention_causal(
            q.reshape(1, prompt_len, cfg.num_kv_heads, -1, cfg.head_dim),
            k.contiguous(), v.contiguous())
        x = x + att.reshape(1, prompt_len, cfg.q_dim) @ lp["attn"]["wo"]
        x = x + ffn_mod.dense_fwd(
            lp["ffn"], rms_norm(x, lp["ffn_norm"], cfg.norm_eps), cfg)
        # scatter this layer's K/V into the planned pages
        kp = torch.nn.functional.pad(k[0], (0, 0, 0, 0, 0, pad))
        vp = torch.nn.functional.pad(v[0], (0, 0, 0, 0, 0, pad))
        upd = torch.stack([kp, vp], dim=1).reshape(
            n_pages, ps, 2, cfg.num_kv_heads, cfg.head_dim)
        kv = pages_mod.write_pages(kv, i, pids, upd)
    logits = _head(params, x[0, -1:], cfg)
    return kv, logits


def _logits_at(params, kv, last_tokens, page_table, *, seq_len, cfg):
    """Logits for the last prompt position using only cached pages (prefix
    hit: no prefill recompute). Runs the stack on the single last token,
    attending over the shared pages."""
    dev = last_tokens.device
    x = params["embed"][last_tokens.long()][None]               # [1, 1, D]
    pos = torch.tensor([seq_len - 1], dtype=torch.int32, device=dev)
    kv_view = pages_mod.PagedKV(
        store=kv.store, page_table=page_table[None],
        seq_len=torch.tensor([seq_len], dtype=torch.int32, device=dev))
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + _attend_paged(lp, h, cfg, kv_view, i, pos, active)
        x = x + ffn_mod.dense_fwd(
            lp["ffn"], rms_norm(x, lp["ffn_norm"], cfg.norm_eps), cfg)
    return _head(params, x[0], cfg)
