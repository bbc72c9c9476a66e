"""Phase 3 of ``chip_smoke.py`` holds every kernel shape phase 14 gives.

Phase 14 runs each ``MODEL_ARCHS`` configuration in bf16 at full width
and fails on the card when a kernel launch has a shape that phase 3 does
not hold against its plain version in both dtypes. These cases find such
a gap on the CPU: for each configuration, the shapes of rows 4
(``decode_attention``: [B, KvH, G, Dh, T]) and 5
(``flash_attention_causal``: q [B, S, KvH, G, Dh]) follow from its config
alone (``chip_smoke.kernel_shapes``, which phase 14 also holds equal to
the launches it records on the card), and each must be one of
``chip_smoke.phase3_shapes()``. Likewise for phase 15's bf16 family
runs: each cut, its rows 5 / 5b shape (in phase 3's forward and
backward cases) and the launches and blockwise calls a step must take,
from the config alone. No model runs.
"""
import dataclasses

import pytest

import chip_smoke as cs
from repro_torch.configs import get_config


def _cfg(name, depth):
    cfg = get_config(name)
    return dataclasses.replace(cfg, num_layers=depth) if depth else cfg


@pytest.mark.parametrize("name,depth", cs.MODEL_ARCHS,
                         ids=[n for n, _ in cs.MODEL_ARCHS])
def test_phase3_holds_every_phase14_kernel_shape(name, depth):
    cfg = _cfg(name, depth)
    shapes = cs.kernel_shapes(cfg)
    n_flash, n_decode, _ = cs.attention_layers(cfg)
    assert {n for n, _ in shapes} == (
        {"flash_attention_causal"} if n_flash else set()) | (
        {"decode_attention"} if n_decode else set())
    for kernel, shape in shapes:
        assert len(shape) == 5 and all(x > 0 for x in shape), shape
        if kernel == "flash_attention_causal":
            b, s, kvh, g, dh = shape
            # llava's sequence is its patches and half the text
            assert (b, s) == (cs.MODEL_B, cs.MODEL_S // 2 + cfg.num_patches
                              if cfg.frontend == "patches" else cs.MODEL_S)
        else:
            b, kvh, g, dh, t = shape
            assert b == cs.MODEL_B and t >= cs.MODEL_MAX_LEN
        if cfg.attention != "mla":
            assert kvh * g == cfg.num_heads and dh == cfg.head_dim
    missing = shapes - cs.phase3_shapes()
    assert not missing, f"{name}: phase 3 does not hold {sorted(missing)}"


def test_new_archs_bring_group_eight_to_both_rows():
    """qwen3-32b (64 / 8 heads, Dh 128) is the first configuration with
    G = 8: decode takes its two-pass merge there (G > 4), and the flash
    forward and backward hold the shape in both dtypes."""
    shapes = cs.kernel_shapes(get_config("qwen3-32b"))
    assert shapes == {("flash_attention_causal", (2, 512, 8, 8, 128)),
                      ("decode_attention", (2, 8, 8, 128, 1024))}
    assert ((2, 512, 8, 8, 128), "models") in cs.BWD_CASES
    assert ((2, 512, 8, 4, 128), "models") in cs.BWD_CASES
    names = [n for n, _ in cs.MODEL_ARCHS]
    for arch in ("mistral-nemo-12b", "nemotron-4-15b", "qwen3-32b"):
        assert dict(cs.MODEL_ARCHS)[arch] is None, arch    # whole
        assert arch in names


# ---------------------------------------------------------------------------
# phase 15's bf16 training runs of five more families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", cs.FAMILY_ARCHS)
def test_phase15_family_shapes_launches_and_depth(name):
    """Each family's training batch (B = 2; llava 1,024 text tokens
    beside its patches, the others 2,048) gives rows 5 and 5b one q shape,
    which phase 3 holds forward and backward (each case in both dtypes);
    each step launches row 5 twice a causal layer (remat "full": the
    forward and the recompute) and row 5b once, all on wgmma, and runs
    blockwise only seamless's encoder self-attention and cross-attention,
    each forward and recompute; the depth is the deepest whose 12 B a
    parameter stay within the bound."""
    full = get_config(name)
    cfg, gib = cs.family_config(name)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (full.d_model, full.num_heads,
                                           full.num_kv_heads, full.head_dim,
                                           full.d_ff, full.vocab_size)
    assert cfg.dtype == "bfloat16" and cfg.remat == "full"
    # the depth: within the bound, and one more layer would pass it
    assert gib == cs.TRAIN_BYTES_PER_PARAM * cs.n_params(cfg) / 2 ** 30
    assert gib <= cs.FAMILY_BUDGET_GIB
    if cfg.num_layers < full.num_layers:
        deeper = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
        assert cs.TRAIN_BYTES_PER_PARAM * cs.n_params(deeper) / 2 ** 30 \
            > cs.FAMILY_BUDGET_GIB
    text = 1024 if cfg.frontend == "patches" else 2048
    seq = text + (cfg.num_patches if cfg.frontend == "patches" else 0)
    shape = (2, seq, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
             cfg.head_dim)
    assert cs.family_kernel_shape(cfg) == shape
    assert (shape, "training") in cs.FLASH_CASES
    assert (shape, "training") in cs.BWD_CASES
    n = cfg.num_layers
    want = {"flash_attention_causal": 2 * n,
            "flash_attention_causal/wgmma": 2 * n,
            "flash_attention_causal_bwd": n,
            "flash_attention_causal_bwd/wgmma": n,
            "flash_attention_causal_bwd/stats": n,
            "flash_attention_causal_bwd/dkdv": n,
            "flash_attention_causal_bwd/dq": n}
    blockwise = 2 * (cfg.encoder_layers + n) if cfg.enc_dec else 0
    assert cs.train_step_launches(cfg) == (want, blockwise)
    # held step by step: a wrong count or a blockwise call fails the run
    step = (dict(want), {"flash": blockwise, "decode": 0})
    assert cs.check_train_launches(cfg, [step] * 4) == want
    for bad in ({**want, "flash_attention_causal_bwd/cuda_cores": 1},
                {**want, "flash_attention_causal": 2 * n + 1}):
        with pytest.raises(AssertionError):
            cs.check_train_launches(cfg, [step, (bad, step[1])])
    with pytest.raises(AssertionError):
        cs.check_train_launches(cfg, [(want, {"flash": blockwise + 1,
                                              "decode": 0})])


def test_phase15_depths_as_reckoned():
    """The cuts phase 15 prints: seamless whole, llava 20 of 32,
    mistral-nemo 12 of 40, nemotron 4 of 32 (its 256,000 x 6,144 embed
    and head are 3.15 G), qwen3 6 of 64."""
    depths = {n: cs.family_config(n)[0].num_layers for n in cs.FAMILY_ARCHS}
    assert depths == {"seamless-m4t-large-v2": 24,
                      "llava-next-mistral-7b": 20, "mistral-nemo-12b": 12,
                      "nemotron-4-15b": 4, "qwen3-32b": 6}
    assert cs.family_config("seamless-m4t-large-v2")[0].encoder_layers == 24
    assert set(cs.TRAIN_FAMILY_SHAPES) == {
        cs.family_kernel_shape(cs.family_config(n)[0])
        for n in cs.FAMILY_ARCHS}
    # the float32 replays hold four more archs, mamba2's SSD among them
    assert set(cs.GRAD_ARCHS) >= {"mamba2-370m", "mistral-nemo-12b",
                                  "nemotron-4-15b", "qwen3-32b"}
