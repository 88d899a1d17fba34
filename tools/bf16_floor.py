"""How far a model's own bf16 arithmetic lies from its f32 one, by
depth: the floor that any second bf16 arithmetic of the same model (a
mesh that rounds its products differently) meets.

For each ``ARCH[:LAYERS]`` (the published config, cut to LAYERS layers),
one process on the card builds the model from seed 0 with bf16 weights
and runs ``launch.serve.teacher_forced`` (2 prompts prefilled, 4 decode
steps fed fixed tokens): in bf16 activations, again (it must repeat bit
for bit), with the other cuBLAS library (``preferred_blas_library``:
another GEMM algorithm at the same precision), and in f32 activations
over the same bf16 weights. Prints, per config, the relative L2 a step
of each against the first run, and one JSON line.

Needs a card. From the repo root:

    python3 tools/bf16_floor.py zamba2-2.7b:12 zamba2-2.7b rwkv6-1.6b:4

The default is the configs ``chip_smoke.py``'s phase ``tp_serve`` holds
or prints for the recurrent families, Whisper and two decoders.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")]

DEFAULT = ("zamba2-2.7b:6", "zamba2-2.7b:12", "zamba2-2.7b:24",
           "zamba2-2.7b", "rwkv6-1.6b:2", "rwkv6-1.6b:4", "rwkv6-1.6b",
           "whisper-base", "glm4-9b", "qwen2-vl-7b")


def rel_l2(got, want):
    import numpy as np
    return [float(np.linalg.norm(x - y) / np.linalg.norm(y))
            for x, y in zip(got, want)]


def floor(arch: str, layers, card: str) -> dict:
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch).replace(param_dtype="bfloat16")
    if layers:
        cfg = cfg.replace(num_layers=layers)
    model = init_model(cfg, seed=0)
    kw = dict(batch=2, max_len=448 if cfg.family == "audio" else 2048,
              steps=4)
    lib = torch.backends.cuda.preferred_blas_library()
    first = serve.teacher_forced(model, cfg, **kw)[2]
    again = serve.teacher_forced(model, cfg, **kw)[2]
    other = ("cublaslt" if str(lib).endswith("Cublas") else "cublas")
    torch.backends.cuda.preferred_blas_library(other)
    try:
        blas = serve.teacher_forced(model, cfg, **kw)[2]
    finally:
        torch.backends.cuda.preferred_blas_library(lib)
    f32 = cfg.replace(dtype="float32")
    model.adtype = torch.float32
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = f32
    wide = serve.teacher_forced(model, f32, **kw)[2]
    out = dict(layers=cfg.num_layers, repeat=rel_l2(again, first),
               other_blas=rel_l2(blas, first), bf16_vs_f32=rel_l2(first,
                                                                   wide))
    print(f"{arch} at {cfg.num_layers} layers: bf16 against f32 "
          f"activations {[f'{x:.3e}' for x in out['bf16_vs_f32']]}, "
          f"another cuBLAS library {[f'{x:.3e}' for x in out['other_blas']]}"
          f", a repeat {[f'{x:.1e}' for x in out['repeat']]} [{card}]",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("bf16_floor: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    res = {}
    for spec in argv or DEFAULT:
        arch, _, layers = spec.partition(":")
        res[spec] = floor(arch, int(layers) if layers else None, card)
    print(json.dumps(dict(card=card, floors=res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
