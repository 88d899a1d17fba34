"""The answering side of the program: a VLM decoder behind
``ServingEngine`` and ``VenusService``, over the memory of the
configuration named by ``memory_config`` (built by ``venus_ingest``),
with the benchmark's weights.

The configuration's ``model`` gives the decoder (Hugging Face key
names), ``engine`` the slots, cache length and cache type, ``service``
the frames a request's vision tokens come from."""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from perfbench import weights
from perfbench.systems import venus_ingest
from perfbench.world import CameraWorld

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def memory_config(cfg: dict) -> dict:
    """The configuration named by ``memory_config`` (or given there
    whole, as the CPU tests do)."""
    m = cfg["memory_config"]
    return m if isinstance(m, dict) else load_config(m)


def decoder_shape(m: dict):
    return weights.tower_shape(
        layers=m["num_hidden_layers"], d=m["hidden_size"],
        heads=m["num_attention_heads"], kv_heads=m["num_key_value_heads"],
        head_dim=m["head_dim"], d_ff=m["intermediate_size"],
        vocab=m["vocab_size"], gated=True, head=True)


def build_decoder(cfg: dict, seed: int, device):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import Transformer
    m = cfg
    mc = ModelConfig(
        name=cfg["name"], family="vlm", num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        activation=m["hidden_act"], gated_mlp=True, pos_type="mrope",
        mrope_sections=tuple(m["mrope_section"]), rope_theta=m["rope_theta"],
        norm_eps=m["rms_norm_eps"], vision_tokens=m["vision_tokens"],
        max_seq_len=m["max_position_embeddings"],
        tie_embeddings=m["tie_word_embeddings"], dtype=m["torch_dtype"],
        param_dtype=m["torch_dtype"])
    model = Transformer(mc, weights.MetaGenerator()).to_empty(
        device=device)
    weights.load(model, weights.groups(seed, cfg["name"], decoder_shape(m),
                                       device=device))
    return model


def build(cfg: dict, traffic: dict, seed: int, device):
    """→ (service, world, embedder, memory configuration): the memory
    filled by ``memory_ticks`` ticks of every camera, then the engine."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.venus_service import VenusService
    mem_cfg = memory_config(cfg)
    world = CameraWorld.from_traffic(traffic, seed, device)
    t0 = time.perf_counter()
    mgr, emb = venus_ingest.build(mem_cfg, seed, device, world.streams)
    t1 = time.perf_counter()
    for i in range(traffic["memory_ticks"]):
        mgr.ingest_tick(world.tick(i))
    t2 = time.perf_counter()
    e = cfg["engine"]
    engine = ServingEngine(build_decoder(cfg, seed, device),
                           batch_slots=e["batch_slots"], max_len=e["max_len"],
                           cache_dtype=getattr(torch, e["cache_dtype"]))
    svc = VenusService(mgr, engine, max_frames=cfg["service"]["max_frames"],
                       patch=mem_cfg["vision_config"]["patch_size"])
    print(f"setup: MEM and manager {t1 - t0:.3f} s, {traffic['memory_ticks']}"
          f" memory ticks {t2 - t1:.3f} s, decoder and engine "
          f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
    return svc, world, emb, mem_cfg
