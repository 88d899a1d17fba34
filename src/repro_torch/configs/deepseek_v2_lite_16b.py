"""DeepSeek-V2-Lite (16B) — MLA + fine-grained MoE.

27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6 —
MLA kv_lora=512, 2 shared + routed top-6 [arXiv:2405.04434]

The full DeepSeek-V2 has 160 routed experts; the Lite model has 64 routed
and 2 shared experts, as hf:deepseek-ai/DeepSeek-V2-Lite.
"""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

_MLA = MLAConfig(
    q_lora_rank=0,                # Lite has no query compression
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        source="arXiv:2405.04434",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        attn_type="mla",
        mla=_MLA,
        moe=MoEConfig(num_experts=64, experts_per_token=6, d_ff=1408,
                      num_shared_experts=2, shared_d_ff=2816,
                      first_dense_layers=1, dense_d_ff=10944),
        rope_theta=10000.0,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-lite-16b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        max_seq_len=512,
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=64, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32),
        # capacity_factor = E/k ⇒ zero token drops ⇒ routing is exact and
        # chunking-invariant, which the prefill/decode parity tests rely on
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=128,
                      num_shared_experts=1, shared_d_ff=128,
                      first_dense_layers=1, dense_d_ff=256,
                      capacity_factor=2.0),
    )
