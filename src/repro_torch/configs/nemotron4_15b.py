"""Nemotron-4-15B — dense decoder, GQA kv=8, squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819]
Nemotron-4 uses a non-gated squared-ReLU MLP and RoPE.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        source="arXiv:2402.16819",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        activation="relu2",
        gated_mlp=False,
        norm_eps=1e-5,
        rope_theta=10000.0,
        max_seq_len=4096,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="nemotron-4-15b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=1024,
        vocab_size=512,
        max_seq_len=512,
    )
