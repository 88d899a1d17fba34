"""Venus MEM — the multimodal embedding model the paper builds memory with.

The paper uses BGE-VL-large [arXiv:2412.14475] (CLIP-family dual encoder).
The same *shape* of model as a dual-tower encoder on the transformer
substrate: a text tower over tokens and a vision tower over precomputed
patch embeddings (the frontend is a stub), each mean-pooled and projected
into a shared, L2-normalised embedding space.
"""

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class MEMConfig:
    name: str = "venus-mem-large"
    embed_dim: int = 768           # shared image-text space
    text: ModelConfig = None       # type: ignore[assignment]
    vision: ModelConfig = None     # type: ignore[assignment]


def _tower(name: str, layers: int, d: int, heads: int, d_ff: int,
           vocab: int, seq: int, learned: bool = False) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=d // heads,
        d_ff=d_ff,
        vocab_size=vocab,
        activation="gelu",
        gated_mlp=False,
        pos_type="learned" if learned else "rope",
        max_seq_len=seq,
    )


def config() -> MEMConfig:
    # ~300M total: BGE-VL-large class.
    return MEMConfig(
        name="venus-mem-large",
        embed_dim=768,
        text=_tower("mem-text", 12, 768, 12, 3072, 32768, 512),
        vision=_tower("mem-vision", 12, 1024, 16, 4096, 0, 1024,
                      learned=True),
    )


def small_config() -> MEMConfig:
    """~100M-class MEM."""
    return MEMConfig(
        name="venus-mem-small",
        embed_dim=512,
        text=_tower("mem-text-s", 6, 512, 8, 2048, 8192, 128),
        vision=_tower("mem-vision-s", 6, 640, 10, 2560, 0, 256,
                      learned=True),
    )


def smoke_config() -> MEMConfig:
    return MEMConfig(
        name="venus-mem-smoke",
        embed_dim=64,
        text=_tower("mem-text-smoke", 2, 64, 2, 128, 512, 32),
        vision=_tower("mem-vision-smoke", 2, 64, 2, 128, 0, 64,
                      learned=True),
    )
