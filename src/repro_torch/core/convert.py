"""State carried across from the reference, as numpy arrays:

* ``arena_from_numpy`` builds a port ``SessionManager`` whose arena and
  session state are exactly the reference arena's arrays, so both
  packages can be queried over identical memory, independent of ingest;
* ``model_params_from_numpy`` turns the reference's ``Transformer.init``
  parameter tree into the port's ``Transformer`` state dict, and
  ``mem_params_from_numpy`` its ``MEM.init`` tree into a ``MEM`` one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.session import SessionManager, VenusConfig

def _t(x) -> torch.Tensor:
    # np.array copies: the caller's arrays may be read-only views
    return torch.from_numpy(np.array(x))


def _decoder_params(tree: Mapping, head: bool) -> Dict[str, torch.Tensor]:
    """A reference decoder tree → port state-dict entries: ``embed``,
    ``pos_embed``, ``final_norm``, ``lm_head`` (if ``head``) and the
    layer-stacked ``dense_blocks`` split into ``blocks.<i>``."""
    if "moe_blocks" in tree:
        raise NotImplementedError(
            "MoE blocks belong to a later slice of the port (ROADMAP.md)")
    out = {k: _t(tree[k]) for k in ("embed", "pos_embed") if k in tree}
    if head and "lm_head" in tree:
        out["lm_head"] = _t(tree["lm_head"])
    for k, v in tree["final_norm"].items():
        out[f"final_norm.{k}"] = _t(v)
    blocks = tree["dense_blocks"]
    for i in range(len(np.asarray(blocks["ln1"]["w"]))):
        for group, leaves in blocks.items():
            for k, v in leaves.items():
                out[f"blocks.{i}.{group}.{k}"] = _t(np.asarray(v)[i])
    return out


def model_params_from_numpy(cfg: ModelConfig, tree: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """The reference's ``Transformer.init`` tree for ``cfg`` (nested dicts
    of numpy arrays) → a state dict for ``models.transformer.Transformer.
    load_state_dict``, leaf for leaf; arrays keep their dtype
    (``param_dtype``)."""
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} belongs to a later slice of the port "
            f"(ROADMAP.md)")
    if cfg.tie_embeddings == ("lm_head" in tree):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} does not "
                         f"match the tree (lm_head present: "
                         f"{'lm_head' in tree})")
    return _decoder_params(tree, head=True)


def mem_params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's MEM parameter tree (``text``/``vision`` towers with
    layer-stacked ``dense_blocks``, the two projections, ``logit_scale``/
    ``logit_bias``) → a state dict for ``models.mem.MEM.load_state_dict``.
    The towers' unused ``lm_head`` is dropped."""
    out: Dict[str, torch.Tensor] = {}
    for tower in ("text", "vision"):
        for k, v in _decoder_params(tree[tower], head=False).items():
            out[f"{tower}.{k}"] = v
    for k in ("text_proj", "vision_proj", "logit_scale", "logit_bias"):
        out[k] = _t(tree[k])
    return out


def arena_from_numpy(cfg: VenusConfig, embedder, *, emb: np.ndarray,
                     members: np.ndarray, member_count: np.ndarray,
                     index_frame: np.ndarray, sizes: np.ndarray,
                     heads: np.ndarray, keys: np.ndarray,
                     emb_scale: Optional[np.ndarray] = None,
                     sids: Optional[Sequence[int]] = None,
                     device=None) -> SessionManager:
    """emb (S, cap, d) f32 — or int8 with ``emb_scale`` (S, cap) — plus
    members (S, cap, K), member_count / index_frame (S, cap), the ring
    windows' ``sizes`` / ``heads`` (S,) and each session's PRNG key data
    ``keys`` (S, 2) → a manager whose slot s holds session ``sids[s]``
    (default s). The host mirrors are rebuilt from the same arrays (int8
    rows dequantised with their scales), so later inserts continue the
    same memory."""
    emb = np.asarray(emb)
    s, cap, d = emb.shape
    int8 = emb.dtype == np.int8
    if int8 != (cfg.index_dtype == "int8"):
        raise ValueError(f"emb dtype {emb.dtype} does not match "
                         f"cfg.index_dtype={cfg.index_dtype!r}")
    if int8 and emb_scale is None:
        raise ValueError("an int8 arena needs its emb_scale")
    if cap != cfg.memory_capacity or members.shape[2] != cfg.member_cap:
        raise ValueError("arena shape does not match cfg")
    mgr = SessionManager(cfg, embedder, d, device=device)
    sids = list(range(s)) if sids is None else [int(x) for x in sids]
    for sid in sids:
        mgr.create_session(sid)
    a = mgr.arena

    def put(buf, x, dtype):
        # np.array copies: the caller's arrays may be read-only views
        buf.copy_(torch.from_numpy(np.array(x, dtype)).to(a.device))

    put(a.emb, emb, emb.dtype)
    if int8:
        put(a.emb_scale, emb_scale, np.float32)
    put(a.members, members, np.int32)
    put(a.member_count, member_count, np.int32)
    put(a.index_frame, index_frame, np.int32)
    a.sizes[:] = np.asarray(sizes, np.int32)
    a.heads[:] = np.asarray(heads, np.int32)
    a.version += 1
    for slot, sid in enumerate(sids):
        st = mgr.sessions[sid]
        mem = st.memory
        rows = emb[slot].astype(np.float32)
        if int8:
            rows = rows * np.asarray(emb_scale[slot], np.float32)[:, None]
        mem._emb[:] = rows
        mem._members[:] = members[slot]
        mem._member_count[:] = member_count[slot]
        mem._index_frame[:] = index_frame[slot]
        mem._size = int(sizes[slot])
        mem._head = int(heads[slot])
        mem.version += 1
        st.key = np.asarray(keys[slot], np.uint32).copy()
    return mgr
