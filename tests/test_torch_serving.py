"""ServeEngine parity: the port (``device="cpu"``, attention through the
kernels' plain versions) against the JAX ``ServeEngine`` on reduced
smollm-360m in float32, with the same parameters
(``params_from_reference``) and ``tests/test_serving.py``'s request
mixes.

Float32 because the two engines are different programs: the reference
decodes through ``attention_decode`` and prefills through the blockwise
``flash_attention``, the port through the Pallas kernels' arithmetic,
and only in float32 is greedy-token equality across formulations well
posed (see ``tests/test_serving.py``). Compared: generated tokens per
rid (equal), the written KV pages (within 1e-5), page tables and
lengths, scheduler stats and health, ``lookup`` and ``progress_view``
(pinned and unpinned; equal) and the state store's arrays (byte-equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_, ref_store_arrays
from repro.configs import reduced_config as ref_reduced_config
from repro.models import init_params as ref_init_params
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch.configs import reduced_config
from repro_torch.core.carry import store_to_numpy
from repro_torch.models.transformer import init_params, params_from_reference
from repro_torch.obs import PhaseTracer
from repro_torch.serving import BohmScheduler, Request, ServeEngine

LOOKUP_KEYS = ("rid", "seq_len", "n_generated", "last_token", "status",
               "known")


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced_config("smollm-360m"),
                              dtype="float32")
    ref_cfg = dataclasses.replace(ref_reduced_config("smollm-360m"),
                                  dtype="float32")
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   cfg, "cpu")
    return cfg, ref_cfg, params, ref_params


def _engines(setup, **kw):
    cfg, ref_cfg, params, ref_params = setup
    ref = RefServeEngine(ref_cfg, ref_params, kv_dtype=jnp.float32, **kw)
    port = ServeEngine(cfg, params, kv_dtype=torch.float32, device="cpu",
                       **kw)
    return ref, port


def _submit(ref, port, rid, prompt, n):
    ref.submit(rid, prompt, max_new_tokens=n)
    port.submit(rid, prompt, max_new_tokens=n)


def _run(ref, port, msg):
    r_done = {r.rid: r.generated for r in ref.run()}
    p_done = {r.rid: r.generated for r in port.run()}
    assert p_done == r_done, msg
    np.testing.assert_allclose(np_(port.kv.pages), np.asarray(ref.kv.pages),
                               rtol=0, atol=1e-5, err_msg=f"{msg}: pages")
    np.testing.assert_array_equal(np_(port.kv.page_table),
                                  np.asarray(ref.kv.page_table))
    np.testing.assert_array_equal(np_(port.kv.seq_len),
                                  np.asarray(ref.kv.seq_len))
    assert dict(port.sched.stats) == dict(ref.sched.stats), msg
    assert port.sched.health() == ref.sched.health(), msg
    assert port.steps == ref.steps, msg
    ref_state = ref_store_arrays(ref.state.store)
    port_state = store_to_numpy(port.state.store)
    assert set(ref_state) == set(port_state)
    for k, a in ref_state.items():
        np.testing.assert_array_equal(port_state[k], a,
                                      err_msg=f"{msg}: state {k}")
    return r_done


def _same_view(ref_view, port_view, msg):
    assert set(ref_view) == set(port_view), msg
    for k in ref_view:
        np.testing.assert_array_equal(np.asarray(port_view[k]),
                                      np.asarray(ref_view[k]),
                                      err_msg=f"{msg}: {k}")


def test_distinct_prompts_match_reference(setup):
    """test_paged_serving_matches_dense's mix: 4 prompts of 16 tokens
    through 3 slots, 6 new tokens each."""
    ref, port = _engines(setup, slots=3, page_size=8, num_pages=64,
                         max_pages_per_seq=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, 16).astype(np.int32) for _ in range(4)]
    for i, p in enumerate(prompts):
        _submit(ref, port, i, p, 6)
    done = _run(ref, port, "distinct")
    assert len(done) == 4 and all(len(g) == 6 for g in done.values())
    _same_view(ref.progress_view(), port.progress_view(), "distinct view")


def test_prefix_sharing_and_gc_match_reference(setup):
    """test_prefix_sharing_and_gc's mix: one prompt 4x through 2 slots —
    prefix hits go through _logits_at, retired pages recycle."""
    ref, port = _engines(setup, slots=2, page_size=8, num_pages=48,
                         max_pages_per_seq=12)
    prompt = np.random.default_rng(1).integers(1, 500, 16).astype(np.int32)
    for i in range(4):
        _submit(ref, port, i, prompt, 4)
    done = _run(ref, port, "prefix")
    assert len({tuple(g) for g in done.values()}) == 1
    assert port.sched.stats["prefix_hits"] >= 2
    assert port.sched.stats["pages_recycled"] > 0


def test_request_state_and_progress_view_match_reference(setup):
    """test_request_state_lookup_via_snapshot_reads' and
    test_progress_view_pin_excludes_inflight_batch's flows over
    state_shards=2: lookups and progress views, live and at a pin held
    while more requests commit."""
    ref, port = _engines(setup, slots=2, page_size=8, num_pages=64,
                         max_pages_per_seq=16, max_rids=16, state_shards=2)
    assert port.state.n_shards == ref.state.n_shards == 2
    rng = np.random.default_rng(2)
    p0, p1 = (rng.integers(1, 500, 8).astype(np.int32) for _ in range(2))
    _submit(ref, port, 0, p0, 3)
    _submit(ref, port, 1, p1, 4)
    done = _run(ref, port, "state 1")
    st = port.lookup([0, 1, 5])
    _same_view(ref.lookup([0, 1, 5]), st, "lookup")
    assert list(st["status"][:2]) == [2, 2] and not st["known"][2]
    assert st["last_token"][0] == done[0][-1]

    pins = (ref.begin_state_snapshot(), port.begin_state_snapshot())
    before = port.progress_view(pins[1])
    _same_view(ref.progress_view(pins[0]), before, "pinned view")
    _submit(ref, port, 2, rng.integers(1, 500, 8).astype(np.int32), 2)
    _run(ref, port, "state 2")
    pinned = port.progress_view(pins[1])
    _same_view(ref.progress_view(pins[0]), pinned, "pinned view again")
    _same_view(before, pinned, "pin is stable")
    assert not pinned["known"][2]
    live = port.progress_view()
    _same_view(ref.progress_view(), live, "live view")
    assert live["known"][2] and live["n_generated"][2] == 2
    _same_view(ref.lookup([2], ts=pins[0]), port.lookup([2], ts=pins[1]),
               "historical lookup")
    ref.release_state_snapshot(pins[0])
    port.release_state_snapshot(pins[1])
    with pytest.raises(ValueError, match="rid"):
        port.lookup([16])


def test_defaults_and_tracer_instants():
    """The reference's defaults (8 slots, pages of 16, 512 pages, 64 per
    sequence, bf16 KV, 1024 rids, state_shards=2) on bf16 parameters:
    one request runs to the end; an enabled tracer records the
    scheduler's instants and the serving spans."""
    cfg = reduced_config("smollm-360m")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, device="cpu",
                      tracer=PhaseTracer(enabled=True))
    assert eng.state.n_shards == 2 and eng.max_rids == 1024
    assert tuple(eng.kv.pages.shape) == (cfg.num_layers, 512, 16, 2,
                                         cfg.num_kv_heads, cfg.head_dim)
    assert eng.kv.pages.dtype == torch.bfloat16
    assert eng.sched.slots == 8 and eng.kv.max_pages == 64
    eng.sched.tracer = eng.tracer
    eng.submit(3, np.arange(1, 33, dtype=np.int32), max_new_tokens=3)
    (req,) = eng.run()
    assert len(req.generated) == 3
    assert eng.lookup([3])["status"][0] == 2
    names = {name for name, _, _ in eng.tracer.instants()}
    assert {"serving/admit", "serving/plan_step"} <= names
    spans = eng.tracer.span_durations()
    assert len(spans["serve/prefill"]) == 1 and len(spans["serve/decode"]) == 2
    assert PhaseTracer().instants() == []


def test_scheduler_page_accounting():
    s = BohmScheduler(slots=2, num_pages=8, page_size=4,
                      max_pages_per_seq=4)
    s.submit(Request(rid=0, prompt=np.array([1, 2, 3, 4], np.int32),
                     max_new_tokens=2))
    s.admit()
    assert s.num_active == 1
    assert (s.page_table[0] >= 0).sum() == 1
    plan = s.plan_step({0: 42})
    assert plan.active[0] and plan.offsets[0] == 0   # new page boundary
    s.complete(0)
    s.end_batch()
    # prompt page is prefix-cached (pinned); the decode page is recycled
    assert len(s.free_pages) == 8 - 1
    assert s.stats["pages_recycled"] == 1


def test_pool_exhaustion_raises():
    s = BohmScheduler(slots=1, num_pages=1, page_size=4,
                      max_pages_per_seq=4)
    s.submit(Request(rid=0, prompt=np.array([1, 2, 3, 4], np.int32),
                     max_new_tokens=8))
    s.admit()
    with pytest.raises(RuntimeError):
        s.plan_step({0: 1})
