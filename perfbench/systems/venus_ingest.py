"""The memory side of the program: the MEM embedder and a
``SessionManager`` of the configuration's streams, built from a
configuration file's numbers with the benchmark's weights.

The configuration's ``text_config``, ``vision_config``,
``projection_dim``, ``rms_norm_eps``, ``rope_theta`` and ``torch_dtype``
give the MEM towers; ``memory`` gives the ``VenusConfig``."""

from __future__ import annotations

import time
from typing import List

import numpy as np

from perfbench import weights


def mem_shape(cfg: dict):
    t, v = cfg["text_config"], cfg["vision_config"]
    groups = []
    for name, tc, learned in (("text", t, 0),
                              ("vision", v, v["max_position_embeddings"])):
        d, h = tc["hidden_size"], tc["num_attention_heads"]
        groups += weights.tower_shape(
            layers=tc["num_hidden_layers"], d=d, heads=h, kv_heads=h,
            head_dim=d // h, d_ff=tc["intermediate_size"],
            vocab=tc.get("vocab_size", 0), gated=False,
            learned_positions=learned, head=False, prefix=name + ".")
    e = cfg["projection_dim"]
    groups.append(("proj", [("text_proj", (t["hidden_size"], e),
                             weights.DENSE),
                            ("vision_proj", (v["hidden_size"], e),
                             weights.DENSE)]))
    return groups


# SigLIP's scale and bias: the encoders do not read them
MEM_CONSTANTS = {"logit_scale": 2.0, "logit_bias": -10.0}


def _tower_config(cfg: dict, tc: dict, name: str, learned: bool):
    from repro_torch.configs.base import ModelConfig
    d, h = tc["hidden_size"], tc["num_attention_heads"]
    return ModelConfig(
        name=name, family="dense", num_layers=tc["num_hidden_layers"],
        d_model=d, num_heads=h, num_kv_heads=h, head_dim=d // h,
        d_ff=tc["intermediate_size"], vocab_size=tc.get("vocab_size", 0),
        activation="gelu", gated_mlp=False,
        pos_type="learned" if learned else "rope",
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        max_seq_len=tc["max_position_embeddings"],
        dtype=cfg["torch_dtype"], param_dtype=cfg["torch_dtype"])


def build_mem(cfg: dict, seed: int, device):
    """The program's MEM with the benchmark's weights (drawn on the
    device, one draw a group)."""
    from repro_torch.configs.venus_mem import MEMConfig
    from repro_torch.models.mem import MEM
    mcfg = MEMConfig(
        name=cfg["name"], embed_dim=cfg["projection_dim"],
        text=_tower_config(cfg, cfg["text_config"], "text", False),
        vision=_tower_config(cfg, cfg["vision_config"], "vision", True))
    mem = MEM(mcfg, weights.MetaGenerator()).to_empty(device=device)
    weights.load(mem, weights.groups(seed, cfg["name"], mem_shape(cfg),
                                     device=device), MEM_CONSTANTS)
    return mem


class TimedEmbedder:
    """The harness's span around the embedder the manager calls: frames
    given and seconds spent in ``embed_frames`` (each call ends in a
    device-to-host read), and every query text with the embedding the
    program returned for it."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: List[tuple] = []          # (t0, t1, frames)
        self.queries: List[tuple] = []        # (text, embedding)

    def embed_frames(self, frames, aux_texts=None, frame_ids=None):
        t0 = time.perf_counter()
        out = self.inner.embed_frames(frames, aux_texts, frame_ids=frame_ids)
        self.calls.append((t0, time.perf_counter(), len(out)))
        return out

    def embed_queries(self, texts):
        out = self.inner.embed_queries(texts)
        self.queries.extend(zip(texts, np.asarray(out, np.float32)))
        return out


def build(cfg: dict, seed: int, device, streams: int):
    """→ (manager, embedder): a ``SessionManager`` of ``streams``
    sessions over the configuration's memory, fed by a timed
    ``MEMEmbedder``."""
    from repro_torch.core.pipeline import MEMEmbedder
    from repro_torch.core.session import SessionManager, VenusConfig
    mem = build_mem(cfg, seed, device)
    emb = TimedEmbedder(MEMEmbedder(
        mem, patch=cfg["vision_config"]["patch_size"],
        text_max_len=cfg["text_config"]["text_max_len"]))
    vcfg = VenusConfig(**cfg["memory"])
    mgr = SessionManager(vcfg, emb, cfg["projection_dim"], device=device)
    for s in range(streams):
        mgr.create_session(s)
    return mgr, emb


def stored_rows(mgr, sid: int) -> dict:
    """A session's memory as the program holds it: each row's embedding
    (the device copy the scans read), index frame, scene id and members
    (in stored order)."""
    mem = mgr.sessions[sid].memory
    n = mem.size
    if mem.arena is not None:
        emb = mem.arena.slot_view("emb", mem.slot)[:n].float().cpu().numpy()
    else:
        emb = mem._emb[:n].copy()
    return {"emb": emb, "index_frame": mem._index_frame[:n].copy(),
            "scene_id": mem._scene_id[:n].copy(),
            "members": [tuple(int(x) for x in
                              mem._members[r, :mem._member_count[r]])
                        for r in range(n)]}
