"""RWKV6-1.6B ("Finch") — attention-free RNN with data-dependent decay.

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 [arXiv:2404.05892]
Sub-quadratic by construction: O(1) recurrent state per layer, so the
long_500k decode shape runs natively.
"""

from repro_torch.configs.base import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        source="arXiv:2404.05892",
        num_layers=24,
        d_model=2048,
        num_heads=32,             # d_model / rwkv.head_dim
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        attn_type="none",
        pos_type="none",
        activation="relu2",       # RWKV channel-mix uses squared ReLU
        gated_mlp=False,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=32),
        max_seq_len=1_048_576,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="rwkv6-1.6b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq_len=512,
        rwkv=RWKVConfig(head_dim=32, decay_lora=16, gate_lora=8),
    )
