"""State carried across from the reference, as numpy arrays:

* ``arena_from_numpy`` builds a port ``SessionManager`` whose arena and
  session state are exactly the reference arena's arrays, so both
  packages can be queried over identical memory, independent of ingest;
* ``model_params_from_numpy`` turns the reference's ``Transformer.init``
  parameter tree, of any family, into the port's ``Transformer`` state
  dict, and ``mem_params_from_numpy`` its ``MEM.init`` tree into a
  ``MEM`` one; ``model_params_to_numpy`` and ``mem_params_to_numpy``
  fold the port's state back into the reference's nested, layer-stacked
  trees (the layout of a checkpoint both packages read).
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.session import SessionManager, VenusConfig

def _t(x) -> torch.Tensor:
    # np.array copies: the caller's arrays may be read-only views
    return torch.from_numpy(np.array(x))


def _flatten(tree: Mapping, prefix: str, i: Optional[int],
             out: Dict[str, torch.Tensor]) -> None:
    """A subtree → ``<prefix>.<name>`` entries, nested dicts (``moe.shared``,
    ``attn``) joined by dots; with ``i``, layer i of a layer-stacked
    subtree."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}.{k}", i, out)
        else:
            out[f"{prefix}.{k}"] = _t(v if i is None else np.asarray(v)[i])


def _n_layers(blocks: Mapping) -> int:
    leaf = blocks
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return len(np.asarray(leaf))


def _model_params(tree: Mapping, head: bool) -> Dict[str, torch.Tensor]:
    """A reference model tree → port state-dict entries. Top-level arrays
    (``embed``, ``pos_embed``, ``enc_pos_embed``, ``lm_head`` if ``head``)
    by name, unstacked subtrees (``final_norm``, ``enc_final_norm``, the
    hybrid's ``shared`` block) by dotted path, and the layer-stacked
    groups split into layers: ``blocks[i]`` → ``blocks.i``,
    ``enc_blocks[i]`` → ``enc_blocks.i``, and a decoder's
    ``dense_blocks[i]`` → ``blocks.i``, then ``moe_blocks[j]`` →
    ``blocks.<n_dense + j>``."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if k in ("blocks", "enc_blocks"):
            for i in range(_n_layers(v)):
                _flatten(v, f"{k}.{i}", i, out)
        elif k in ("dense_blocks", "moe_blocks"):
            continue
        elif isinstance(v, Mapping):
            _flatten(v, k, None, out)
        elif k != "lm_head" or head:
            out[k] = _t(v)
    first = 0
    for group in ("dense_blocks", "moe_blocks"):
        if group not in tree:
            continue
        n = _n_layers(tree[group])
        for i in range(n):
            _flatten(tree[group], f"blocks.{first + i}", i, out)
        first += n
    return out


def model_params_from_numpy(cfg: ModelConfig, tree: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """The reference's ``Transformer.init`` tree for ``cfg`` (nested dicts
    of numpy arrays), of any family → a state dict for
    ``models.transformer.Transformer.load_state_dict``, leaf for leaf (the
    MoE blocks' ``moe.router``, experts and ``moe.shared``, the hybrid's
    stacked Mamba ``blocks`` and unstacked ``shared`` block, the RWKV
    blocks, and the audio tree's ``enc_blocks``, ``enc_pos_embed``,
    ``enc_final_norm`` and decoder blocks with ``ln_x``/``xattn``
    included); arrays keep their dtype (``param_dtype``)."""
    if cfg.tie_embeddings == ("lm_head" in tree):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} does not "
                         f"match the tree (lm_head present: "
                         f"{'lm_head' in tree})")
    return _model_params(tree, head=True)


def mem_params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's MEM parameter tree (``text``/``vision`` towers with
    layer-stacked ``dense_blocks``, the two projections, ``logit_scale``/
    ``logit_bias``) → a state dict for ``models.mem.MEM.load_state_dict``.
    The towers' unused ``lm_head`` is dropped."""
    out: Dict[str, torch.Tensor] = {}
    for tower in ("text", "vision"):
        for k, v in _model_params(tree[tower], head=False).items():
            out[f"{tower}.{k}"] = v
    for k in ("text_proj", "vision_proj", "logit_scale", "logit_bias"):
        out[k] = _t(tree[k])
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _stack_state(state: Mapping[str, torch.Tensor], n_dense: Optional[int]
                 ) -> dict:
    """Port state-dict entries → the reference's nested tree of numpy
    arrays: dotted names nest, and ``blocks.<i>`` / ``enc_blocks.<i>``
    stack on a leading layer axis — with ``n_dense`` (a decoder) into
    ``dense_blocks`` for i < n_dense and ``moe_blocks`` after."""
    leaves: Dict[tuple, np.ndarray] = {}
    layers: Dict[tuple, list] = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] in ("blocks", "enc_blocks"):
            group = parts[0]
            if group == "blocks" and n_dense is not None:
                group = ("dense_blocks" if int(parts[1]) < n_dense
                         else "moe_blocks")
            layers.setdefault((group,) + tuple(parts[2:]), []).append(t)
        else:
            leaves[tuple(parts)] = _np(t)
    for path, ts in layers.items():
        leaves[path] = _np(torch.stack([t.detach() for t in ts]))
    tree: dict = {}
    for path, arr in leaves.items():
        node = tree
        for q in path[:-1]:
            node = node.setdefault(q, {})
        node[path[-1]] = arr
    return tree


def _state(model: Union[nn.Module, Mapping[str, torch.Tensor]]
           ) -> Mapping[str, torch.Tensor]:
    return model.state_dict() if isinstance(model, nn.Module) else model


def model_params_to_numpy(cfg: ModelConfig,
                          model: Union[nn.Module, Mapping[str, torch.Tensor]]
                          ) -> dict:
    """The inverse of ``model_params_from_numpy``: a ``Transformer`` of
    ``cfg`` — or any mapping under its parameter names, such as AdamW's
    moments — → the reference's ``Transformer.init`` tree of numpy arrays
    (a decoder's ``dense_blocks`` / ``moe_blocks``, the other families'
    ``blocks`` and ``enc_blocks``, stacked by layer)."""
    n_dense = None
    if cfg.family not in ("audio", "hybrid") and cfg.rwkv is None:
        n_dense = min(cfg.moe.first_dense_layers if cfg.moe
                      else cfg.num_layers, cfg.num_layers)
    return _stack_state(_state(model), n_dense)


def mem_params_to_numpy(mem: Union[nn.Module, Mapping[str, torch.Tensor]]
                        ) -> dict:
    """The inverse of ``mem_params_from_numpy``: a ``MEM`` — or a mapping
    under its parameter names — → the reference's MEM tree, each tower's
    blocks stacked into ``dense_blocks``; the towers' unused ``lm_head``
    is not there."""
    state = _state(mem)
    tree = {k: _np(state[k]) for k in ("text_proj", "vision_proj",
                                       "logit_scale", "logit_bias")}
    for tower in ("text", "vision"):
        pre = tower + "."
        tree[tower] = _stack_state(
            {k[len(pre):]: v for k, v in state.items()
             if k.startswith(pre)}, n_dense=sys.maxsize)
    return tree


# the coarse tier's arrays ``arena_from_numpy`` takes: the device buffers
# (S, n_coarse, ·) and mask, then the consolidated rows' host state
# (S, coarse_capacity) and the rows in use (S,)
COARSE_KEYS = ("emb", "members", "member_count", "index_frame", "valid",
               "weight", "fid_lo", "fid_hi", "csize")


def arena_from_numpy(cfg: VenusConfig, embedder, *, emb: np.ndarray,
                     members: np.ndarray, member_count: np.ndarray,
                     index_frame: np.ndarray, sizes: np.ndarray,
                     heads: np.ndarray, keys: np.ndarray,
                     emb_scale: Optional[np.ndarray] = None,
                     coarse: Optional[Mapping[str, np.ndarray]] = None,
                     sids: Optional[Sequence[int]] = None,
                     mesh=None, double_buffer: Optional[bool] = None,
                     device=None) -> SessionManager:
    """emb (S, cap, d) f32 — or int8 with ``emb_scale`` (S, cap) — plus
    members (S, cap, K), member_count / index_frame (S, cap), the ring
    windows' ``sizes`` / ``heads`` (S,) and each session's PRNG key data
    ``keys`` (S, 2) → a manager whose slot s holds session ``sids[s]``
    (default s). With ``cfg.coarse_capacity > 0``, ``coarse`` holds the
    coarse tier under ``COARSE_KEYS``: the arena's ``coarse_emb``,
    ``coarse_members``, ``coarse_member_count``, ``coarse_index_frame``
    and ``coarse_valid``, then each memory's consolidated rows'
    ``weight``, ``fid_lo``, ``fid_hi`` (S, coarse_capacity) and
    ``csize`` (S,). The host mirrors are rebuilt from the same arrays
    (int8 rows dequantised with their scales), so later inserts and
    consolidations continue the same memory. ``mesh`` and
    ``double_buffer`` go to the ``SessionManager``: a sharded manager
    places session ``sids[s]`` where its arena puts it, and row s of
    each array goes to that slot's slab."""
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
    if (coarse is not None) != (cfg.coarse_capacity > 0):
        raise ValueError("coarse arrays are needed exactly when "
                         "cfg.coarse_capacity > 0")
    missing = sorted(set(COARSE_KEYS) - set(coarse or COARSE_KEYS))
    if missing:
        raise ValueError(f"coarse lacks {missing}")
    mgr = SessionManager(cfg, embedder, d, mesh=mesh,
                         double_buffer=double_buffer, device=device)
    sids = list(range(s)) if sids is None else [int(x) for x in sids]
    for sid in sids:
        mgr.create_session(sid)
    a = mgr.arena
    if coarse is not None and np.shape(coarse["emb"])[1:] != (a.n_coarse, d):
        raise ValueError("coarse tier shape does not match cfg")
    bufs = [("emb", emb, emb.dtype), ("members", members, np.int32),
            ("member_count", member_count, np.int32),
            ("index_frame", index_frame, np.int32)]
    if int8:
        bufs.append(("emb_scale", emb_scale, np.float32))
    if coarse is not None:
        bufs += [(f"coarse_{k}", coarse[k], t) for k, t in (
            ("emb", np.float32), ("members", np.int32),
            ("member_count", np.int32), ("index_frame", np.int32))]
    for row, sid in enumerate(sids):
        slot = mgr.sessions[sid].memory.slot
        for name, x, dtype in bufs:
            # np.array copies: the caller's arrays may be read-only views
            a.load_slot(name, slot, torch.from_numpy(np.array(x[row],
                                                              dtype)))
        a.sizes[slot] = sizes[row]
        a.heads[slot] = heads[row]
        if coarse is not None:
            a.coarse_valid[slot] = np.asarray(coarse["valid"][row], bool)
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
        if coarse is not None:
            nb = mem.n_blocks
            mem._coarse_emb[:] = coarse["emb"][slot, nb:]
            mem._coarse_members[:] = coarse["members"][slot, nb:]
            mem._coarse_count[:] = coarse["member_count"][slot, nb:]
            mem._coarse_ifr[:] = coarse["index_frame"][slot, nb:]
            mem._coarse_weight[:] = coarse["weight"][slot]
            mem._coarse_fid_lo[:] = coarse["fid_lo"][slot]
            mem._coarse_fid_hi[:] = coarse["fid_hi"][slot]
            mem._coarse_csize = int(coarse["csize"][slot])
        mem.version += 1
        st.key = np.asarray(keys[slot], np.uint32).copy()
    return mgr

