"""Meta-device stand-ins for every (architecture × input shape): the
inputs a step takes, as tensors on the ``meta`` device (shape and dtype,
no storage), the reference's ``repro.launch.specs``.

Shapes:

* train_4k, prefill_32k: ``seq_len`` is the whole sequence; the VLM's
  stub vision embeddings take ``vision_tokens`` of it and the tokens the
  rest; whisper adds its 1,500 encoder frames;
* the decode shapes: one new token against a ``seq_len`` cache;
* long_500k: full-attention GQA archs get the sliding-window variant
  (window 8192); the MLA archs keep their whole latent cache; the
  recurrent families are O(1) by nature.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.params import meta_model

LONG_CONTEXT_WINDOW = 8192


def SDS(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def adapt_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """The long-context attention policy, and ``max_seq_len`` raised to
    the shape's sequence."""
    if shape.name == "long_500k":
        if cfg.attn_type == "gqa" and cfg.sliding_window == 0 \
                and cfg.family not in ("ssm",):
            cfg = cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    if cfg.max_seq_len < shape.seq_len:
        cfg = cfg.replace(max_seq_len=shape.seq_len)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The meta inputs of the step of this shape's kind: ``{"batch":
    ...}`` for train, the prefill step's arguments, or the decode step's
    ``tokens`` and ``cache``."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def extras(out):
        if cfg.family == "vlm":
            out["vision_embeds"] = SDS((b, cfg.vision_tokens, cfg.d_model),
                                       bf16)
        if cfg.family == "audio":
            out["encoder_frames"] = SDS(
                (b, cfg.encoder_seq_len, cfg.d_model), bf16)
        return out

    s_text = s - (cfg.vision_tokens if cfg.family == "vlm" else 0)
    if shape.kind == "train":
        return {"batch": extras({"tokens": SDS((b, s_text), i32),
                                 "labels": SDS((b, s_text), i32)})}
    if shape.kind == "prefill":
        return extras({"tokens": SDS((b, s_text), i32)})
    assert shape.kind == "decode"
    cache = params_shape(cfg).init_cache(b, s, torch.bfloat16,
                                         device="meta")
    return {"tokens": SDS((b, 1), i32), "cache": cache}


# the ``Transformer`` of a config on the ``meta`` device
params_shape = meta_model
