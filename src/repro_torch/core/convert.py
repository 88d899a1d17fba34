"""State carried across from the reference, as numpy arrays:

* ``arena_from_numpy`` builds a port ``SessionManager`` whose arena and
  session state are exactly the reference arena's arrays, so both
  packages can be queried over identical memory, independent of ingest;
* ``mem_params_from_numpy`` turns the reference's ``MEM.init`` parameter
  tree into the port's ``MEM`` state dict.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.session import SessionManager, VenusConfig

_TOWER_LEAVES = ("embed", "pos_embed")


def mem_params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's MEM parameter tree (nested dicts of numpy arrays:
    ``text``/``vision`` towers with layer-stacked ``dense_blocks``, the
    two projections, ``logit_scale``/``logit_bias``) → a state dict for
    ``models.mem.MEM.load_state_dict``. The stacked layer axis is split
    into ``blocks.<i>``; the towers' unused ``lm_head`` is dropped;
    arrays keep their dtype (``param_dtype``)."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, x):
        out[key] = torch.from_numpy(np.array(x))

    for tower in ("text", "vision"):
        t = tree[tower]
        for leaf in _TOWER_LEAVES:
            if leaf in t:
                put(f"{tower}.{leaf}", t[leaf])
        for k, v in t["final_norm"].items():
            put(f"{tower}.final_norm.{k}", v)
        blocks = t["dense_blocks"]
        n = len(np.asarray(blocks["ln1"]["w"]))
        for i in range(n):
            for group, leaves in blocks.items():
                for k, v in leaves.items():
                    put(f"{tower}.blocks.{i}.{group}.{k}", np.asarray(v)[i])
    for k in ("text_proj", "vision_proj", "logit_scale", "logit_bias"):
        put(k, tree[k])
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
