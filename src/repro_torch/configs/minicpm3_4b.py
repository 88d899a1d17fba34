"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention.

62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448 — MLA
[hf:openbmb/MiniCPM3-4B]
"""

from repro_torch.configs.base import MLAConfig, ModelConfig

_MLA = MLAConfig(
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
)


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        source="hf:openbmb/MiniCPM3-4B",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        head_dim=64,              # v_head_dim; qk dims come from MLA config
        d_ff=6400,
        vocab_size=73448,
        attn_type="mla",
        mla=_MLA,
        activation="silu",
        tie_embeddings=True,
        rope_theta=10000.0,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="minicpm3-4b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        max_seq_len=512,
        mla=MLAConfig(q_lora_rank=96, kv_lora_rank=64,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=64),
    )
