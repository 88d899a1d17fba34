"""OLMoE-1B-7B — fully sparse MoE decoder, 64 experts top-8.

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8
[arXiv:2409.02060]
"""

from repro_torch.configs.base import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        source="arXiv:2409.02060",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50304,
        qk_norm=True,             # OLMoE applies QK-norm
        moe=MoEConfig(num_experts=64, experts_per_token=8, d_ff=1024,
                      router_aux_coef=0.01),
        rope_theta=10000.0,
        max_seq_len=4096,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="olmoe-1b-7b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        max_seq_len=512,
        # capacity_factor = E/k ⇒ zero drops ⇒ chunking-invariant routing
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=128,
                      capacity_factor=2.0),
    )
