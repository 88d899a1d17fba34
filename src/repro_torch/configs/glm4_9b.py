"""GLM-4-9B — dense decoder, RoPE (partial rotary), aggressive GQA kv=2.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 [hf:THUDM/glm-4-9b]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        source="hf:THUDM/glm-4-9b",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=151552,
        activation="silu",
        rope_theta=10000.0,
        rope_fraction=0.5,        # GLM applies rotary to half the head dim
        max_seq_len=8192,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="glm4-9b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        max_seq_len=512,
    )
