"""The 10 assigned architectures, exact configs from the assignment table.

A copy of ``repro.configs.archs`` (data, no translation): the port keeps
its own so it never imports the JAX package. Tests hold the two tables
equal field by field.
"""
from __future__ import annotations

from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                      SSMConfig)

# [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small
SMOLLM_360M = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    head_dim=64, d_ff=2560, vocab_size=49152,
    activation="swiglu",
)

# [hf:mistralai/Mistral-Nemo-Base-2407; hf] — 128k ctx
MISTRAL_NEMO_12B = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    activation="swiglu", rope_theta=1e6,
)

# [hf:Qwen/Qwen3-8B; hf] — qk_norm, GQA
QWEN3_32B = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936,
    activation="swiglu", qk_norm=True, rope_theta=1e6,
)

# [arXiv:2402.16819] — GQA, squared-ReLU
NEMOTRON_4_15B = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=256000,
    activation="squared_relu",
)

# [arXiv:2405.21060] — SSD (state-space duality), attention-free
MAMBA2_370M = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    head_dim=0, d_ff=0, vocab_size=50280,
    attention="none", activation="swiglu",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
)

# [hf:llava-hf/llava-v1.6-mistral-7b-hf] — anyres tiling (frontend stubbed)
LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    activation="swiglu",
    frontend="patches", num_patches=2304,   # anyres 4 tiles + base, 24x24 pooled
)

# [hf:xai-org/grok-1] — 8 experts top-2
GROK_1_314B = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=32768, vocab_size=131072,
    activation="gelu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768),
)

# [arXiv:2405.04434] — MLA kv_lora=512, 2 shared + 64 routed top-6
DEEPSEEK_V2_LITE_16B = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=102400,
    attention="mla", activation="swiglu",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, first_moe_layer=1, dense_d_ff=10944),
)

# [arXiv:2308.11596] — enc-dec, multimodal (frame frontend stubbed)
SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256206,
    activation="gelu", enc_dec=True, encoder_layers=24,
    frontend="frames",
)

# [arXiv:2411.13676] — parallel attn+mamba heads, SWA + 3 global layers
HYMBA_1_5B = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    attention="swa", window=1024, global_attn_layers=(0, 15, 31),
    activation="swiglu", hybrid=True,
    # SSD chunk stays 256: the 128-tile experiment (EXPERIMENTS.md perf
    # iteration 6) was REFUTED — +7% flops (doubled inter-chunk scan work)
    # with no peak-memory win on the compiled artifact.
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
)

ALL_ARCHS = {
    c.name: c for c in [
        SMOLLM_360M, MISTRAL_NEMO_12B, QWEN3_32B, NEMOTRON_4_15B,
        MAMBA2_370M, LLAVA_NEXT_MISTRAL_7B, GROK_1_314B,
        DEEPSEEK_V2_LITE_16B, SEAMLESS_M4T_LARGE_V2, HYMBA_1_5B,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (shapes only)."""
    full = get_config(name)
    kw = dict(
        name=full.name + "-smoke",
        num_layers=2, d_model=64,
        num_heads=4 if full.num_heads else 0,
        num_kv_heads=2 if full.num_kv_heads else 0,
        head_dim=16 if full.head_dim else 0,
        d_ff=128 if full.d_ff else 0,
        vocab_size=512,
    )
    if full.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4, top_k=2, d_ff_expert=64,
            num_shared=full.moe.num_shared,
            first_moe_layer=min(full.moe.first_moe_layer, 1),
            dense_d_ff=96 if full.moe.dense_d_ff else 0)
    if full.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
    if full.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              chunk_size=32)
    if full.enc_dec:
        kw["encoder_layers"] = 2
    if full.frontend == "patches":
        kw["num_patches"] = 16
    if full.window:
        kw["window"] = 32
        kw["global_attn_layers"] = (0,)
    return dataclasses_replace(full, **kw)


def dataclasses_replace(cfg: ModelConfig, **kw) -> ModelConfig:
    import dataclasses
    return dataclasses.replace(cfg, **kw)
