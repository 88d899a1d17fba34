"""DeepSeek-LLM-7B — llama-architecture dense decoder.

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400 [arXiv:2401.02954]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        source="arXiv:2401.02954",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
        activation="silu",
        rope_theta=10000.0,
        max_seq_len=4096,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="deepseek-7b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        max_seq_len=512,
    )
