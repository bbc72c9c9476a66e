"""Phase 3 of ``chip_smoke.py`` holds every kernel shape phase 14 gives.

Phase 14 runs each ``MODEL_ARCHS`` configuration in bf16 at full width
and fails on the card when a kernel launch has a shape that phase 3 does
not hold against its plain version in both dtypes. These cases find such
a gap on the CPU: for each configuration, the shapes of rows 4
(``decode_attention``: [B, KvH, G, Dh, T]) and 5
(``flash_attention_causal``: q [B, S, KvH, G, Dh]) follow from its config
alone (``chip_smoke.kernel_shapes``, which phase 14 also holds equal to
the launches it records on the card), and each must be one of
``chip_smoke.phase3_shapes()``. No model runs.
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
