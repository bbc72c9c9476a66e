"""The port's cost counter, dry run and roofline against the JAX
package's, on the CPU.

- ``counting.dispatch_costs`` against the reference's ``jaxpr_costs``:
  the calibration of ``tests/test_sharding.py`` (L chained matmuls give
  ``2 L B D^2`` dot flops, their gradient 3x), then every family's
  reduced train and prefill step on unsharded abstract arguments (the
  port's on fake CPU tensors, where its attention runs the reference's
  blockwise code, so both walk the same products). The products only
  the reference's program has are added to the port's count first
  (``_reference_only_dots``: the recomputed chunk scores of its
  ``jax.checkpoint``-ed scan bodies, and the outer products XLA makes of
  SSD's three-operand einsums, which the port computes as ``mul``s).
  Then ``dot_flops`` within 1 %. ``flops`` within ``FLOPS_TOL``: XLA's
  and aten's decompositions differ in the elementwise ops (``mean`` is
  one aten op and two XLA ones, ``silu`` one and two, softmax counts 5 a
  row). ``bytes`` within ``BYTES_TOL``: the reference charges no bytes
  to casts and counts each elementwise op's write alike, but the two
  programs cast and materialise at different places (the port's float32
  upcasts before a product, its padding and stacking). ``bytes_fused``
  within ``FUSED_TOL``: the reference adds a scan's carries twice an
  iteration and its xs / ys once (``counting.py:103-112``), which the
  port's Python loops do not have (the SSD recurrence's carries are most
  of the difference), and the port's dot operands carry its float32
  upcasts.
- The attention kernels' operators on fake tensors: shapes only, one
  call each, counted by their formulas.
- Collective bytes against hand-derived ones on a fake (2, 2) mesh: one
  sharded matmul's all-reduce, one FSDP all-gather, one reduce-scatter
  of a gradient.
- ``roofline.analyze_cell`` equal to the reference's on the same record
  (the hardware constants patched equal), and ``benchmarks_torch/
  summarize.py``'s roofline section equal to the reference's rendering
  of the same two synthetic dry-run files.
- A local dry-run cell of each reduced smollm-360m shape, the CLI, and
  the float32 plain backward's exact zero at S = 1.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.launch import counting as ref_counting
from repro.launch import roofline as ref_roofline
from repro.launch import specs as ref_specs
from repro.models import transformer as ref_tf
from repro_torch.configs import reduced_config
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ops
from repro_torch.launch import counting, dryrun, roofline, specs

ARCHS = sorted(REF_ARCHS)
B, S = 2, 64
DOT_TOL, FLOPS_TOL, BYTES_TOL, FUSED_TOL = 0.01, 0.02, 0.15, 0.40


@pytest.fixture(scope="module")
def fake_world():
    """torch's fake process group for this module's DeviceMeshes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    opened = not dist.is_initialized()
    if opened:
        dist.init_process_group("fake", rank=0, world_size=512,
                                store=FakeStore())
    yield
    if opened:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
def test_counter_calibration():
    L, b, d = 4, 32, 64

    def f(x, ws):
        h = x
        for w in ws:
            h = h @ w
        return h.sum()

    x = torch.randn(b, d)
    ws = [torch.randn(d, d, requires_grad=True) for _ in range(L)]
    c = counting.dispatch_costs(f, x, ws)
    expect = 2 * L * b * d * d
    assert abs(c["dot_flops"] - expect) / expect < 0.01

    # the gradient of x and the ws: 3L products (a scan's transpose
    # computes the carry's gradient in every iteration; autograd would
    # prune the first layer's dx if x were not asked for)
    x.requires_grad_(True)

    def grad(x, ws):
        return torch.autograd.grad(f(x, ws), [x, *ws])

    g = counting.dispatch_costs(grad, x, ws)
    assert abs(g["dot_flops"] - 3 * expect) / (3 * expect) < 0.01
    # the reference's calibration gives the same numbers
    r = ref_counting.jaxpr_costs(
        lambda x, ws: jax.lax.scan(lambda h, w: (h @ w, None), x,
                                   ws)[0].sum(),
        jax.ShapeDtypeStruct((b, d), jnp.float32),
        jax.ShapeDtypeStruct((L, d, d), jnp.float32))
    assert r["dot_flops"] == c["dot_flops"]


def _ref_costs(arch, kind):
    cfg = ref_reduced(arch)
    params = ref_tf.abstract_params(cfg)
    sds = jax.ShapeDtypeStruct
    i32, bf16 = jnp.int32, jnp.bfloat16
    if cfg.frontend == "patches":
        n = S - cfg.num_patches
        batch = {"tokens": sds((B, n), i32), "patches": sds(
            (B, cfg.num_patches, ref_tf.VISION_EMBED_DIM), bf16)}
        if kind == "train":
            batch["labels"] = sds((B, n), i32)
    elif cfg.enc_dec and kind == "prefill":
        batch = {"frames": sds((B, S, ref_tf.AUDIO_FEAT_DIM), bf16),
                 "tokens": sds((B, 1024), i32)}
    else:
        batch = {"tokens": sds((B, S), i32)}
        if kind == "train":
            batch["labels"] = sds((B, S), i32)
            if cfg.enc_dec:
                batch["frames"] = sds((B, S, ref_tf.AUDIO_FEAT_DIM), bf16)
    if kind == "prefill":
        return ref_counting.jaxpr_costs(ref_specs.make_prefill_step(cfg),
                                        params, batch)
    m = jax.tree.map(lambda x: sds(x.shape, jnp.float32), params)
    return ref_counting.jaxpr_costs(ref_specs.make_train_step(cfg), params,
                                    {"m": m, "v": m, "step": sds((), i32)},
                                    batch)


def _port_costs(arch, kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    fn, args, _ = specs.build_cell(
        arch, kind, None, cfg=reduced_config(arch),
        shape={"seq": S, "batch": B, "kind": kind}, device="cpu",
        fake_mode=fake)
    with fake:
        return counting.dispatch_costs(fn, *args)


def _reference_only_dots(arch, kind, monkeypatch):
    """The products the reference's step has and the port's does not,
    from the shapes of the port's own forward calls, as the reference's
    counter counts a ``dot_general`` (its flops; its operands and output
    in bytes, fused or not):

    - ``"bqkgd,bckd->bqkgc"``, each scanned chunk's scores (every chunk
      of ``_flash_scan_all``, the interior chunks of
      ``_flash_causal_blocks``): the reference's ``jax.checkpoint``
      around the chunk body recomputes them once more in the backward
      (train only; the port leaves that checkpoint out, ``models/
      layers.py``'s module doc);
    - SSD's outer products ``"bnij,bnijh->bnijh"`` (C.B times the decay
      mask), ``"bnqh,bnqhp->bnqhp"`` (decay times dt times x) and
      ``"bnqd,bnqh->bnqhd"`` (C times the decay from the chunk's start):
      ``dot_general``s in XLA's pairwise contraction of the reference's
      three-operand float32 einsums, ``mul``s in the port (once in the
      forward; in train 4x: the forward, the remat recompute and the two
      transposed products of the backward, which move what the forward
      moves).

    Returns ``({"dot_flops", "bytes"}, the port's costs)``."""
    from repro_torch.models import layers, ssm
    calls = []

    def record(name, fn):
        def call(*a, **kw):
            if torch._C._current_graph_task_id() == -1:    # not backward
                calls.append((name, a, kw))
            return fn(*a, **kw)
        return call

    for mod, name in ((layers, "_flash_causal_blocks"),
                      (layers, "_flash_scan_all"), (ssm, "ssd_chunked")):
        monkeypatch.setattr(mod, name, record(name, getattr(mod, name)))
    port = _port_costs(arch, kind)
    extra = {"dot_flops": 0, "bytes": 0}

    def dot(n, a_elems, b_elems, out_elems, k, itemsize_ab):
        extra["dot_flops"] += n * 2 * out_elems * k
        extra["bytes"] += n * ((a_elems + b_elems) * itemsize_ab
                               + out_elems * 4)

    for name, a, kw in calls:
        if name == "ssd_chunked":
            n = 4 if kind == "train" else 1
            b, s, nh, hd = a[0].shape
            ds, q = a[3].shape[-1], a[5]
            bn = b * (s // q)
            dot(n, bn * q * q, bn * q * q * nh, bn * q * q * nh, 1, 4)
            dot(n, bn * q * nh, bn * q * nh * hd, bn * q * nh * hd, 1, 4)
            dot(n, bn * q * ds, bn * q * nh, bn * q * nh * ds, 1, 4)
            continue
        if kind != "train":
            continue
        q, k = a[0], a[1]
        b, sq, h, dh = q.shape
        kvh, size = k.shape[2], q.element_size()
        chunk, window = kw["chunk"], kw.get("window", 0)
        if name == "_flash_causal_blocks":
            nq = sq // chunk
            band = (window + chunk - 1) // chunk if window else nq
            n = sum(i - max(0, i - band) for i in range(nq))
            rows = chunk
        else:
            n = max(1, (k.shape[1] + chunk - 1) // chunk)
            rows = sq
        dot(n, b * rows * h * dh, b * chunk * kvh * dh, b * rows * h * chunk,
            dh, size)
    return extra, port


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_costs_match_reference(arch, kind, monkeypatch):
    ref = _ref_costs(arch, kind)
    extra, port = _reference_only_dots(arch, kind, monkeypatch)
    for key, tol, add in (("dot_flops", DOT_TOL, extra["dot_flops"]),
                          ("flops", FLOPS_TOL, extra["dot_flops"]),
                          ("bytes", BYTES_TOL, extra["bytes"]),
                          ("bytes_fused", FUSED_TOL, extra["bytes"])):
        rel = abs(port[key] + add - ref[key]) / ref[key]
        assert rel <= tol, (key, port[key], add, ref[key])
    assert port["kernels"] == {}          # the CPU runs the blockwise code


def test_kernel_operators_on_fake_tensors(monkeypatch):
    """flash forward + backward and decode on fake tensors: shapes only
    (the operators' fake implementations: neither a kernel nor a plain
    version runs, no launch), one call each, counted by the formulas of
    ``counting.KERNEL_COSTS``. (CPU fake tensors: on this CPU build of
    torch a fake ``cuda`` tensor cannot enter an operator; the card's
    dry run takes that route.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import decode_attention as dmod

    def boom(*a, **kw):
        raise AssertionError("a plain version ran on fake tensors")

    monkeypatch.setattr(fmod, "flash_attention_causal_plain", boom)
    monkeypatch.setattr(fmod, "flash_attention_causal_bwd_plain", boom)
    monkeypatch.setattr(dmod, "decode_attention_plain", boom)
    b, s, kvh, g, dh, t = 2, 96, 5, 3, 64, 1024
    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        q = torch.empty((b, s, kvh, g, dh), dtype=torch.bfloat16,
                        requires_grad=True)
        k, v = (torch.empty((b, s, kvh, dh), dtype=torch.bfloat16,
                            requires_grad=True) for _ in range(2))

        def step(q, k, v):
            out = ops.flash_attention_causal(q, k, v)
            return out, torch.autograd.grad(out.float().sum(), (q, k, v))

        c = counting.dispatch_costs(step, q, k, v)
        out, grads = step(q, k, v)
        assert out.shape == q.shape
        assert [x.shape for x in grads] == [q.shape, k.shape, v.shape]
        qd = torch.empty((b, kvh, g, dh), dtype=torch.bfloat16)
        kc = torch.empty((b, t, kvh, dh), dtype=torch.bfloat16)
        kl = torch.empty((b,), dtype=torch.int32)
        d = counting.dispatch_costs(ops.decode_attention, qd, kc, kc, kl)
    assert dict(ops.LAUNCHES) == before
    assert c["kernels"] == {"repro_torch::flash_attention_causal": 1,
                            "repro_torch::flash_attention_causal_bwd": 1}
    pairs = b * kvh * g * s * (s + 1) // 2
    assert c["dot_flops"] == 4 * dh * pairs + 10 * dh * pairs
    assert d["kernels"] == {"repro_torch::decode_attention": 1}
    assert d["dot_flops"] == 4 * b * t * kvh * g * dh
    qb, kb = q.numel() * 2, k.numel() * 2
    assert counting.flash_cost(q, k, v) == {
        "flops": 4 * dh * pairs, "bytes": 2 * qb + 2 * kb}
    assert counting.flash_bwd_cost(q, k, v, q, q)["bytes"] == \
        4 * qb + 4 * kb


def test_collective_bytes_hand_derived(fake_world):
    """On a fake (2, 2) (data, model) mesh, float32: x [8, 64] sharded on
    its columns over model times w [64, 32] sharded on its rows gives a
    partial sum, all-reduced over model into [8, 32] (2 x 1,024 B); an
    FSDP parameter [64, 32] sharded on rows over data all-gathered whole
    (8,192 B); its gradient, partial over data, reduce-scattered back to
    rows (a [32, 32] shard of 4,096 B x (2 - 1))."""
    from repro_torch.launch.mesh import device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    mesh = device_mesh((2, 2), ("data", "model"), "cpu")

    def run(fn):
        counter = counting.collective_counter()
        with counter:
            fn()
        return counting.collective_costs(counter.records)

    x = distribute_tensor(torch.randn(8, 64), mesh, [Replicate(), Shard(1)])
    w = distribute_tensor(torch.randn(64, 32), mesh, [Replicate(), Shard(0)])
    mm = run(lambda: (x @ w).redistribute(mesh, [Replicate(), Replicate()]))
    assert mm["all-reduce"] == 2 * 8 * 32 * 4 and mm["count"] == 1
    p = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0), Replicate()])
    ag = run(lambda: p.redistribute(mesh, [Replicate(), Replicate()]))
    assert ag["all-gather"] == 64 * 32 * 4 and ag["count"] == 1
    grad = DTensor.from_local(torch.randn(64, 32), mesh,
                              [Partial(), Replicate()], run_check=False)
    rs = run(lambda: grad.redistribute(mesh, [Shard(0), Replicate()]))
    assert rs["reduce-scatter"] == 32 * 32 * 4 * (2 - 1) and rs["count"] == 1
    assert rs["total_bytes"] == rs["reduce-scatter"]


# ---------------------------------------------------------------------------
# the roofline and the summary
# ---------------------------------------------------------------------------
def _record(devices, flops, byts, fused, coll, active, peak):
    return {"status": "ok", "devices": devices,
            "jaxpr": {"flops": flops, "dot_flops": flops * 0.9,
                      "bytes": byts, "bytes_fused": fused},
            "collectives": {"total_bytes": coll},
            "model": {"params": active, "active_params": active},
            "memory": {"peak_bytes_per_device": peak}}


SYNTHETIC = {
    "smollm-360m|train_4k|single": _record(256, 6.1e15, 4.0e14, 9e13, 3e9,
                                           409_007_040, 2 ** 33),
    "smollm-360m|prefill_32k|single": _record(256, 9e14, 2e14, 4e13, 1e9,
                                              409_007_040, 2 ** 32),
    "smollm-360m|decode_32k|single": _record(256, 2e11, 3e12, 2e12, 5e8,
                                             409_007_040, 2 ** 31),
    "mamba2-370m|long_500k|single": _record(256, 1e10, 6e10, 5e10, 1e7,
                                            420_136_448, 2 ** 30),
    "hymba-1.5b|decode_32k|single": _record(256, 3e11, 8e12, 6e12, 2e9,
                                            1_641_790_720, 2 ** 32),
    "deepseek-v2-lite-16b|decode_32k|single": _record(
        256, 5e11, 9e12, 7e12, 3e9, 2_660_000_000, 2 ** 34),
    "qwen3-32b|train_4k|multi": _record(512, 2e17, 1e16, 2e15, 8e10,
                                        32_000_000_000, 2 ** 35),
    "grok-1-314b|train_4k|single": {"status": "error", "error": "x"},
}


def _patch_hardware(monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16",
                        ref_roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", ref_roofline.ICI_BW)


def test_analyze_cell_matches_reference(monkeypatch):
    _patch_hardware(monkeypatch)
    for key, rec in SYNTHETIC.items():
        assert roofline.analyze_cell(key, rec) == \
            ref_roofline.analyze_cell(key, rec), key
    assert ref_roofline.TOKENS == roofline.TOKENS


def test_roofline_uses_the_h100_model():
    row = roofline.analyze_cell("smollm-360m|train_4k|single",
                                SYNTHETIC["smollm-360m|train_4k|single"])
    assert row["t_compute_s"] == 6.1e15 / (256 * 989e12)
    assert row["t_memory_s"] == 4.0e14 / (256 * 3.35e12)
    assert row["t_collective_s"] == 3e9 / 450e9


def test_summarize_roofline_matches_reference(monkeypatch, tmp_path, capsys):
    import importlib
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    ref_sum = importlib.import_module("benchmarks.summarize")
    port_sum = importlib.import_module("benchmarks_torch.summarize")
    _patch_hardware(monkeypatch)
    opt = {k: dict(v, jaxpr={**v["jaxpr"], "bytes": v["jaxpr"]["bytes"] / 2})
           if v["status"] == "ok" else v for k, v in SYNTHETIC.items()}
    (tmp_path / "dryrun_baseline.json").write_text(json.dumps(SYNTHETIC))
    (tmp_path / "dryrun_opt.json").write_text(json.dumps(opt))
    monkeypatch.setattr(ref_sum, "RESULTS", tmp_path)
    monkeypatch.setattr(port_sum, "RESULTS", tmp_path)
    ref_sum.main()
    want = capsys.readouterr().out
    want = want[want.index("## Roofline"):]
    assert port_sum.print_roofline_section()
    got = capsys.readouterr().out
    assert got[got.index("## Roofline"):] == want
    assert "| smollm-360m | train_4k |" in want


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_local_dryrun_cell(fake_world, shape):
    rec = dryrun.run_cell("smollm-360m", shape, "local", device="cpu",
                          reduced=True)
    assert rec["status"] == "ok" and rec["devices"] == 1
    assert set(rec) >= {"lower_s", "compile_s", "devices", "memory", "cost",
                        "jaxpr", "collectives", "model"}
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"] > 0
    assert mem["peak_bytes_per_device"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    if shape == "decode_32k":                 # the cache is written in place
        assert mem["alias_bytes"] > 0
    assert rec["collectives"]["total_bytes"] == 0   # one rank moves nothing
    assert rec["jaxpr"]["dot_flops"] > 0
    row = roofline.analyze_cell(f"smollm-360m|{shape}|local", rec)
    assert row["chips"] == 1 and row["t_compute_s"] > 0
    skipped = dryrun.run_cell("smollm-360m", "long_500k", "local",
                              device="cpu", reduced=True)
    assert skipped["status"] == "skipped"


def test_dryrun_cli_records_and_caches(fake_world, tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "smollm-360m", "--shape", "prefill_32k", "--mesh",
            "local", "--device", "cpu", "--reduced", "--out", str(out)]
    dryrun.main(argv)
    data = json.loads(out.read_text())
    assert data["smollm-360m|prefill_32k|local"]["status"] == "ok"
    dryrun.main(argv)
    assert "[cached] smollm-360m|prefill_32k|local" in capsys.readouterr().out


def test_dryrun_records_an_error_cell(monkeypatch, tmp_path, capsys):
    def boom(*a, **kw):
        raise RuntimeError("Operator aten.foo.default does not have a "
                           "sharding strategy registered.")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k", "--mesh",
                 "local", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())["smollm-360m|train_4k|local"]
    assert rec["status"] == "error" and rec["op"] == "aten.foo.default"


# ---------------------------------------------------------------------------
# the float32 backward at S = 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 16), (2, 1, 2, 3, 64),
                                   (1, 1, 1, 4, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_exact_zero_at_one_position(shape, dtype):
    """At S = 1, P = 1 and out = v_0, so dS = dP - D = 0: dq and dk are
    exactly 0, and dv is dout summed over the group."""
    rng = np.random.default_rng(sum(shape))
    b, s, kvh, g, dh = shape

    def randn(*size):
        return torch.from_numpy(rng.standard_normal(size).astype(
            np.float32)).to(dtype)

    q, k, v, dout = randn(*shape), randn(b, s, kvh, dh), \
        randn(b, s, kvh, dh), randn(*shape)
    out = fmod.flash_attention_causal_plain(q, k, v)
    dq, dk, dv = fmod.flash_attention_causal_bwd_plain(q, k, v, out, dout)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv.float(), dout.float().sum(dim=3),
                               rtol=1e-2 if dtype == torch.bfloat16 else 0,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-6)
