"""Model/config schema for all assigned architectures.

A copy of ``repro.configs.base`` (plain dataclasses, no translation):
the port keeps its own so it never imports the JAX package.

Every architecture in the assignment is expressed as a ``ModelConfig``. The
fields cover the union of the families we must support: dense GQA
transformers, MLA (DeepSeek), MoE (token-choice top-k with optional shared
experts), Mamba-2 SSD, hybrid attn+SSM (Hymba), encoder-decoder (Seamless),
and stub modality frontends (LLaVA patches / Seamless frames).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    # layer index of first MoE layer; earlier layers use a dense FFN
    first_moe_layer: int = 0
    dense_d_ff: int = 0          # d_ff of the leading dense layers (if any)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0         # 0 = full-rank q projection (V2-Lite)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | moe | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention flavour ---
    attention: str = "full"       # full | mla | swa | none
    qk_norm: bool = False
    window: int = 0               # sliding-window size when attention == swa
    # Hymba keeps a few global full-attention layers; everything else is SWA.
    global_attn_layers: Tuple[int, ...] = ()
    # --- FFN flavour ---
    activation: str = "swiglu"    # swiglu | squared_relu | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: bool = False          # parallel attention + SSM heads per layer
    # --- encoder/decoder ---
    enc_dec: bool = False
    encoder_layers: int = 0
    # --- modality frontend stub ---
    frontend: str = "none"        # none | patches | frames
    num_patches: int = 0          # VLM: patch-embedding count prepended to text
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # flash-attention chunk length used by the jnp blockwise implementation
    attn_chunk: int = 512
    # remat policy for the training step:
    #   "full" (save layer inputs only) — default; the A/B in
    #   EXPERIMENTS.md perf iteration 2 REFUTED "save_attn" (-1.5% flops
    #   for +43% peak HBM) and "dots" (-12% flops for +2.2x peak).
    #   "save_attn" | "dots" | "none" remain selectable.
    remat: str = "full"

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded so embedding/lm_head shard cleanly over TP=16."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_params(self) -> int:
        """Analytic parameter count (used for 6ND model-flops accounting)."""
        d, f, l = self.d_model, self.d_ff, self.num_layers
        n = 0
        # embeddings (+ untied lm_head)
        n += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        enc_l = self.encoder_layers if self.enc_dec else 0
        dec_l = l

        def attn_params() -> int:
            if self.attention == "mla" and self.mla is not None:
                m = self.mla
                qd = self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p = d * qd                                   # W_q
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)   # W_dkv + W_kr
                p += m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)       # W_ukv
                p += self.num_heads * m.v_head_dim * d       # W_o
                return p
            if self.attention == "none":
                return 0
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        def ssm_params() -> int:
            if self.ssm is None:
                return 0
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            p = d * (2 * di + 2 * s.n_groups * s.d_state + nh)   # in_proj
            p += s.d_conv * (di + 2 * s.n_groups * s.d_state)    # conv
            p += nh * 2                                          # A_log, D
            p += di * d                                          # out_proj
            return p

        def ffn_params(layer: int) -> int:
            if self.moe is not None and layer >= self.moe.first_moe_layer:
                mo = self.moe
                expert = 3 * d * mo.d_ff_expert
                p = mo.num_experts * expert + mo.num_shared * expert
                p += d * mo.num_experts                      # router
                return p
            if self.moe is not None and self.moe.dense_d_ff:
                return 3 * d * self.moe.dense_d_ff
            k = 3 if self.activation == "swiglu" else 2
            return k * d * f

        for layer in range(dec_l):
            if self.family == "ssm":
                n += ssm_params()
            else:
                n += attn_params()
                if self.hybrid:
                    n += ssm_params()
                n += ffn_params(layer)
            if self.enc_dec:
                n += attn_params()                           # cross attention
        for _ in range(enc_l):
            n += attn_params() + ffn_params(10**9)
        return n

    def num_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.num_params()
        mo = self.moe
        total = self.num_params()
        expert = 3 * self.d_model * mo.d_ff_expert
        n_moe_layers = self.num_layers - mo.first_moe_layer
        inactive = n_moe_layers * (mo.num_experts - mo.top_k) * expert
        return total - inactive
