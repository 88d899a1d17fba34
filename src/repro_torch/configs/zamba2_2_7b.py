"""Zamba2-2.7B — hybrid Mamba2 backbone with a shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242]

The backbone is Mamba2; a single weight-tied (shared) attention+MLP block
is applied every ``shared_attn_period`` layers (Zamba2 interleaves shared
blocks every ~6 layers). At long_500k the shared attention runs with a
sliding window so the KV cache stays bounded (the reference's hardware
adaptation).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

_PERIOD = 6


def _pattern(n: int) -> str:
    # 'A' marks layers where the shared attention block runs before Mamba2.
    return "".join("A" if (i % _PERIOD == _PERIOD - 1) else "M"
                   for i in range(n))


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, head_dim=64),
        layer_pattern=_pattern(54),
        shared_attn_period=_PERIOD,
        sliding_window=8192,      # bounds shared-attn KV at 500k decode
        max_seq_len=1_048_576,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="zamba2-2.7b-smoke",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq_len=512,
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, head_dim=32,
                      chunk=16),
        layer_pattern="MAMA",
        shared_attn_period=2,
        sliding_window=128,
    )
