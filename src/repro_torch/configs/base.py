"""Model configuration: one frozen ``ModelConfig`` per architecture, with
the reference's field names and defaults. This slice carries the fields
the dense decoder reads (it has no LM head, so no ``tie_embeddings``);
the MoE, MLA, SSM, RWKV, M-RoPE and encoder-decoder fields come with the
slices that port those models.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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
    attn_type: str = "gqa"        # gqa | mla | none
    pos_type: str = "rope"        # rope | mrope | learned | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # partial-rotary fraction (GLM uses 0.5)
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0       # 0 => full attention

    # numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ----------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)
