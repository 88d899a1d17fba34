"""Whisper-base — encoder-decoder audio transformer backbone.

6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865 — enc-dec, conv
frontend (stub) [arXiv:2212.04356]

Per the assignment carve-out the mel-spectrogram + conv feature extractor
is a STUB: ``input_specs`` provides precomputed frame embeddings of shape
(batch, encoder_seq_len, d_model); we implement the transformer encoder
over those embeddings and the decoder with self+cross attention.

long_500k is SKIPPED for this arch, as in the reference: an enc-dec
audio model has no 524k-token decoder stream analogue.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        source="arXiv:2212.04356",
        num_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        activation="gelu",
        gated_mlp=False,
        pos_type="learned",
        is_encoder_decoder=True,
        num_encoder_layers=6,
        encoder_seq_len=1500,     # 30 s of audio at 50 frames/s
        audio_frontend=True,
        tie_embeddings=True,
        # whisper's native decoder context is 448; the assigned decode_32k
        # shape requires positions up to 32k, so the learned table is sized
        # for the dry-run (the reference's deviation).
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="whisper-base-smoke",
        num_layers=2,
        num_encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        encoder_seq_len=64,
        max_seq_len=64,
    )
