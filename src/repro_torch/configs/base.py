"""Model configuration: one frozen ``ModelConfig`` per architecture, with
the reference's field names and defaults, and the input shapes of the
reference's dry runs (``ShapeSpec``): every family of the reference —
dense, VLM and MoE decoders (GQA or MLA attention, RoPE or M-RoPE), the
Mamba2 hybrid, RWKV6 and the Whisper encoder-decoder.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 0          # 0 => no query compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class MoEConfig:
    """Sparse mixture-of-experts feed-forward."""

    num_experts: int = 64
    experts_per_token: int = 8
    d_ff: int = 1024              # per-expert hidden size
    num_shared_experts: int = 0   # DeepSeek-style always-on experts
    shared_d_ff: int = 0          # hidden size of the shared expert block
    first_dense_layers: int = 0   # leading layers that stay dense
    dense_d_ff: int = 0           # d_ff for those dense layers
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    capacity_factor: float = 1.25  # dispatch capacity per chunk


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    state_dim: int = 64
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64               # chunked-scan block length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix parameters."""

    head_dim: int = 64
    decay_lora: int = 64          # rank of the data-dependent decay LoRA
    gate_lora: int = 32           # rank of token-shift mix LoRAs


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str = "tiny"
    family: str = "dense"         # dense | ssm | hybrid | moe | audio | vlm
    source: str = ""              # citation for the exact numbers

    # trunk --------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 4096

    # flavour ------------------------------------------------------------
    activation: str = "silu"      # silu | gelu | relu2  (relu2 => non-gated)
    gated_mlp: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_type: str = "gqa"        # gqa | mla | none
    pos_type: str = "rope"        # rope | mrope | learned | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # partial-rotary fraction (GLM uses 0.5)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0       # 0 => full attention

    # sub-family configs ---------------------------------------------------
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # layer pattern for hybrids; "M"=mamba2, "A"=attention, "R"=rwkv6,
    # "D"=dense attn+mlp. Empty => homogeneous from family/attn_type.
    layer_pattern: str = ""
    shared_attn_period: int = 0   # zamba2: weight-tied attn block every k layers

    # encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0      # fixed encoder frames (whisper: 1500)

    # multimodal stub -----------------------------------------------------
    vision_tokens: int = 0        # VLM: patch-embedding tokens per request
    audio_frontend: bool = False  # whisper: precomputed frame embeddings

    # numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ----------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolve the per-layer block kinds for this architecture."""
        if self.layer_pattern:
            assert len(self.layer_pattern) == self.num_layers, (
                f"{self.name}: layer_pattern len {len(self.layer_pattern)} "
                f"!= num_layers {self.num_layers}")
            return tuple(self.layer_pattern)
        if self.family == "ssm" and self.rwkv is not None:
            return tuple("R" * self.num_layers)
        if self.family == "ssm":
            return tuple("M" * self.num_layers)
        return tuple("D" * self.num_layers)

    def param_count(self) -> int:
        """Non-embedding parameter count (``models.params``)."""
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_active_params_analytic
        return count_active_params_analytic(self)


# ---------------------------------------------------------------------------
# Input shapes of the reference's dry runs.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get_shape(name: str) -> ShapeSpec:
    try:
        return INPUT_SHAPES[name]
    except KeyError:
        raise KeyError(
            f"unknown shape {name!r}; choose from {sorted(INPUT_SHAPES)}")
