"""Qwen2-VL-7B — the paper's own cloud VLM; M-RoPE decoder backbone.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — M-RoPE, dynamic
resolution [arXiv:2409.12191]

The ViT vision encoder and projector are a stub, as in the reference:
requests carry precomputed patch embeddings (vision_tokens, d_model)
placed ahead of the text tokens; the language decoder uses multimodal
rotary position embedding (head_dim/2 frequency slots split into
temporal/height/width sections).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        source="arXiv:2409.12191",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        activation="silu",
        pos_type="mrope",
        mrope_sections=(16, 24, 24),   # t/h/w over head_dim/2 = 64
        rope_theta=1_000_000.0,
        vision_tokens=1024,            # patch embeddings per request (stub)
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="qwen2-vl-7b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        vision_tokens=16,
        mrope_sections=(4, 6, 6),
        max_seq_len=512,
    )
