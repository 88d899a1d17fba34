"""Every model family of the reference — the dense, VLM and MoE
decoders (GQA or MLA blocks), the Mamba2 hybrid, RWKV6 and the Whisper
encoder-decoder — with their caches, one ``nn.Module`` per layer where
the reference scans stacked layers.

A model holds ``embed`` (vocab, d), ``pos_embed`` (max_seq_len, d) for
learned positions, ``final_norm``, ``blocks`` and, unless the embeddings
are tied, ``lm_head`` (d, vocab); every leaf keeps the reference's name,
so ``core.convert`` maps a reference parameter tree onto it one to one.
By family, ``blocks`` holds:

* dense / VLM / MoE: ``AttnBlock``s — the reference's two groups of
  blocks (``dense_blocks``, then ``moe_blocks``: an MoE config's
  ``first_dense_layers`` dense blocks of ``dense_d_ff``, then blocks with
  ``moe`` in place of ``mlp``) are ``blocks[:n_dense]`` and
  ``blocks[n_dense:]``;
* hybrid (Zamba2): ``MambaBlock``s, and one weight-tied ``AttnBlock``,
  ``shared``, applied after each group of ``shared_attn_period`` of them;
* RWKV: ``RWKVBlock``s (time mix, then channel mix);
* audio (Whisper): decoder ``AttnBlock``s with cross attention over the
  encoder's output; the encoder is ``enc_pos_embed``, ``enc_blocks``
  (bidirectional ``AttnBlock``s over the given frame embeddings) and
  ``enc_final_norm``.

The MEM towers are built without a head (``head=False``) and read only
``hidden``. Norms are RMSNorm, or LayerNorm (with a ``b`` leaf) for the
audio and RWKV families, as in the reference.

``apply`` modes: "train" (full logits), "prefill" (fills the cache,
returns last-position logits only), "decode" (one token against the
cache); it returns the MoE blocks' summed aux loss. Train mode follows
the caller's grad mode, and with ``remat`` checkpoints what the
reference's ``jax.checkpoint`` does: each decoder, encoder or RWKV
layer body and the hybrid's superstep (a Mamba2 group and the shared
block). Prefill and decode build no autograd graph. Parameters are
frozen (``requires_grad=False``) until a trainer unfreezes its model.
The cache keeps the reference's layout: ``pos`` (B,), for M-RoPE
``mrope_delta`` (B,), for audio ``enc_out`` (B, S_enc, d) in the cache
dtype, and the groups of ``GROUPS`` — ``dense`` and ``moe``, ``mamba``
and ``shared``, ``rwkv``, ``self`` — each holding its layers' (or
shared-block applications') cache leaves stacked on a leading axis, the
batch on axis 1. The recurrent groups (``mamba``, ``rwkv``) are f32
whatever the cache dtype.
Layers write their slices of the stacked leaves in place.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed_init, layer_norm,
                                       mlp_hidden, mlp_init, rms_norm)
from repro_torch.launch.sharding import (LocalShard, TensorParallel,
                                         check_tp_family, is_placed, local,
                                         model_copy, place_cache,
                                         place_params)
from repro_torch.util import resolve_device

Cache = Optional[Dict[str, Any]]
# the model's own parameters (groups) that ``_run`` reads
_OWN = ("head", "embed", "pos_embed", "enc_pos_embed", "final_norm",
        "enc_final_norm")
# the cache's layer-stacked groups (batch on axis 1)
GROUPS = ("dense", "moe", "mamba", "shared", "rwkv", "self")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class _Tree(nn.Module):
    """A parameter tree read like the reference's nested dicts
    (``p["router"]``, ``"shared" in p``): tensors become parameters,
    dicts ``nn.ParameterDict`` children."""

    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            if isinstance(v, dict):
                self.add_module(k, _params(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules


def _layernorm_family(cfg: ModelConfig) -> bool:
    return cfg.family == "audio" or cfg.rwkv is not None


def _norm_init(cfg: ModelConfig, dtype, device) -> nn.ParameterDict:
    p = {"w": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if _layernorm_family(cfg):
        p["b"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return _params(p)


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def _remat(fn: Callable, remat: bool) -> Callable:
    """``fn``, or with ``remat`` ``fn`` under activation checkpointing:
    its activations are recomputed in the backward pass."""
    if not remat:
        return fn

    def run(*args, **kw):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _write(views: Optional[dict], new: Optional[dict]) -> None:
    """Copy a layer's new cache leaves into its views of the stacked
    leaves."""
    if views is not None and new is not None:
        for k, t in new.items():
            views[k].copy_(t)


def _local_tree(mod: nn.Module) -> dict:
    """The local shard of each parameter of ``mod``, nested by the
    parameter names' paths (an MoE block's ``shared`` under ``moe``)."""
    out = {}
    for name, p in mod.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = local(p)
    return out


class _Block(nn.Module):
    """A layer that runs on the model axis: ``Transformer.set_tp`` gives
    it the model's ``TensorParallel`` and the local shards of each of its
    parameter groups (its children), which ``_part`` reads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.tp = None
        self.shards = None

    def _part(self, name: str):
        """A parameter group as the layer computes on it: the module's own
        off the model axis; on it the local shards — those kept by
        ``set_tp`` outside a graph, else read now from the live
        parameters (FSDP2 swaps them around each forward, and a gradient
        reaches a parameter only through its ``to_local()``)."""
        if self.tp is None:
            return getattr(self, name)
        if self.shards is None or torch.is_grad_enabled():
            return _local_tree(getattr(self, name))
        return self.shards[name]


class AttnBlock(_Block):
    """Pre-norm attention block: ``ln1``, ``attn`` (GQA or MLA), with
    ``cross`` ``ln_x`` and ``xattn`` (cross attention over the encoder's
    output), ``ln2``, and ``mlp`` of ``d_ff`` or, with ``use_moe``,
    ``moe``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 d_ff: int, use_moe: bool = False, cross: bool = False):
        super().__init__(cfg)
        self.d_ff = d_ff
        dtype, dev = _dtype(cfg.param_dtype), gen.device
        self.ln1 = _norm_init(cfg, dtype, dev)
        self.ln2 = _norm_init(cfg, dtype, dev)
        init = attn.mla_init if cfg.attn_type == "mla" else attn.gqa_init
        self.attn = _params(init(gen, cfg, dtype))
        self.cross = cross
        if cross:
            self.ln_x = _norm_init(cfg, dtype, dev)
            self.xattn = _params(attn.cross_attn_init(gen, cfg, dtype))
        self.use_moe = use_moe
        if use_moe:
            self.moe = _Tree(moe_mod.moe_init(gen, cfg, dtype))
        else:
            self.mlp = _params(mlp_init(gen, cfg.d_model, d_ff,
                                        gated=cfg.gated_mlp, dtype=dtype))

    def step(self, x: torch.Tensor, *, positions: torch.Tensor,
             mrope_positions: Optional[torch.Tensor] = None,
             cache: Optional[dict] = None,
             cache_pos: Optional[torch.Tensor] = None, mode: str = "train",
             kv_lengths: Optional[torch.Tensor] = None,
             enc_out: Optional[torch.Tensor] = None,
             cache_rows: Optional[Tuple[int, int]] = None
             ) -> Tuple[torch.Tensor, Optional[dict],
                        Optional[torch.Tensor]]:
        """→ (x, cache, the MoE aux loss or None). ``cache_rows``: see
        ``attention.gqa_attention``."""
        cfg = self.cfg
        h = _norm(cfg, self._part("ln1"), x)
        if cfg.attn_type == "mla":
            a, cache = attn.mla_attention(
                self._part("attn"), cfg, h, positions=positions, cache=cache,
                cache_pos=cache_pos, mode=mode, kv_lengths=kv_lengths,
                tp=self.tp, cache_rows=cache_rows)
        else:
            a, cache = attn.gqa_attention(
                self._part("attn"), cfg, h, positions=positions,
                mrope_positions=mrope_positions, cache=cache,
                cache_pos=cache_pos, mode=mode, kv_lengths=kv_lengths,
                tp=self.tp, cache_rows=cache_rows)
        x = x + a
        if self.cross:
            assert enc_out is not None
            x = x + attn.cross_attention(
                self._part("xattn"), cfg, _norm(cfg, self._part("ln_x"), x),
                enc_out, tp=self.tp)
        h = _norm(cfg, self._part("ln2"), x)
        if self.use_moe:
            m, aux = moe_mod.moe_apply(self._part("moe"), cfg, h, tp=self.tp)
            return x + m, cache, aux
        return x + self._mlp(h), cache, None

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The MLP; on the model axis its columns (h entering them through
        ``TensorParallel.copy``), then the rows of ``w_down`` summed over
        the ranks."""
        mlp = self._part("mlp")
        if attn.split_cols(self.tp, mlp["w_up"], self.d_ff):
            h = model_copy(self.tp, h)
        return attn.row_parallel(
            self.tp, mlp_hidden(mlp, h, self.cfg.activation),
            mlp["w_down"].to(h.dtype), self.d_ff)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The Whisper encoder's block: bidirectional self-attention with
        the GQA weights, no positions, then the MLP. On the model axis
        each rank runs its heads (or, where they do not divide it, its
        rows of the frames over every head) and its MLP columns."""
        cfg = self.cfg
        h = _norm(cfg, self._part("ln1"), x)
        x = x + attn.full_attention(self._part("attn"), cfg, h, h,
                                    kv_heads=cfg.num_kv_heads, tp=self.tp,
                                    seq_parallel=True)
        return x + self._mlp(_norm(cfg, self._part("ln2"), x))

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        return self.step(x, positions=positions)[0]


class MambaBlock(_Block):
    """Pre-norm Mamba2 block: ``ln``, ``mamba``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__(cfg)
        dtype = _dtype(cfg.param_dtype)
        self.ln = _norm_init(cfg, dtype, gen.device)
        self.mamba = _params(ssm_mod.mamba2_init(gen, cfg, dtype))

    def step(self, x: torch.Tensor, cache: Optional[dict], mode: str
             ) -> torch.Tensor:
        y, new = ssm_mod.mamba2_apply(
            self._part("mamba"), self.cfg,
            _norm(self.cfg, self._part("ln"), x), cache=cache, mode=mode,
            tp=self.tp)
        _write(cache, new)
        return x + y


class RWKVBlock(_Block):
    """RWKV6 block: ``ln1``, the time mix, ``ln2``, the channel mix (both
    mixes' leaves under ``mix``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__(cfg)
        dtype = _dtype(cfg.param_dtype)
        self.ln1 = _norm_init(cfg, dtype, gen.device)
        self.ln2 = _norm_init(cfg, dtype, gen.device)
        self.mix = _params(rwkv_mod.rwkv6_init(gen, cfg, dtype))

    def step(self, x: torch.Tensor, state: Optional[dict], mode: str
             ) -> torch.Tensor:
        cfg, mix = self.cfg, self._part("mix")
        y, st_tm = rwkv_mod.rwkv6_time_mix(
            mix, cfg, _norm(cfg, self._part("ln1"), x), state, mode,
            tp=self.tp)
        x = x + y
        y, st_cm = rwkv_mod.rwkv6_channel_mix(
            mix, cfg, _norm(cfg, self._part("ln2"), x), state, mode,
            tp=self.tp)
        # both mixes read the state before either is written
        _write(state, {**st_tm, **st_cm})
        return x + y


class Transformer(nn.Module):
    """A model of any family. ``gen`` draws the initial weights (on its
    device) with the reference's scales; ``head=False`` leaves out the LM
    head (the MEM towers)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 head: bool = True, place: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = None
        self.shards = None
        self.adtype = _dtype(cfg.dtype)
        dtype, dev = _dtype(cfg.param_dtype), gen.device
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, dtype),
                                  requires_grad=False)
        if cfg.pos_type == "learned":
            self.pos_embed = nn.Parameter(
                embed_init(gen, cfg.max_seq_len, cfg.d_model, dtype),
                requires_grad=False)
        else:
            self.pos_embed = None
        self.final_norm = _norm_init(cfg, dtype, dev)
        if head and not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype),
                requires_grad=False)
        else:
            self.lm_head = None
        # blocks of the ``dense`` group; the rest form the ``moe`` group
        self.n_dense = min(cfg.moe.first_dense_layers if cfg.moe
                           else cfg.num_layers, cfg.num_layers)
        # ``place`` (a model built onto the model axis) places what is
        # built so far before the next block is drawn, so a rank holds its
        # shards and one block whole, never the whole model
        placed = place if place is not None else (lambda m: None)

        def build(name: str, make: Callable, n: int):
            setattr(self, name, nn.ModuleList())
            for i in range(n):
                getattr(self, name).append(make(i))
                placed(self)
        placed(self)
        if cfg.family == "audio":
            self.enc_pos_embed = nn.Parameter(
                embed_init(gen, cfg.encoder_seq_len, cfg.d_model, dtype),
                requires_grad=False)
            build("enc_blocks", lambda i: AttnBlock(cfg, gen, d_ff=cfg.d_ff),
                  cfg.num_encoder_layers)
            self.enc_final_norm = _norm_init(cfg, dtype, dev)
            build("blocks", lambda i: AttnBlock(cfg, gen, d_ff=cfg.d_ff,
                                                cross=True), cfg.num_layers)
        elif cfg.family == "hybrid":
            if cfg.num_layers % cfg.shared_attn_period:
                raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are "
                                 f"not groups of {cfg.shared_attn_period}")
            build("blocks", lambda i: MambaBlock(cfg, gen), cfg.num_layers)
            self.shared = AttnBlock(cfg, gen, d_ff=cfg.d_ff)
        elif cfg.rwkv is not None:
            build("blocks", lambda i: RWKVBlock(cfg, gen), cfg.num_layers)
        else:
            dense_ff = (cfg.moe.dense_d_ff if cfg.moe and cfg.moe.dense_d_ff
                        else cfg.d_ff)
            build("blocks", lambda i: AttnBlock(
                cfg, gen, d_ff=dense_ff if i < self.n_dense else cfg.d_ff,
                use_moe=i >= self.n_dense), cfg.num_layers)
        placed(self)

    @property
    def kind(self) -> str:
        """Which family's stack ``apply`` runs: "audio", "hybrid", "rwkv"
        or "decoder" (dense, VLM and MoE)."""
        cfg = self.cfg
        if cfg.family in ("audio", "hybrid"):
            return cfg.family
        return "rwkv" if cfg.rwkv is not None else "decoder"

    @property
    def attn_applications(self) -> int:
        """Self-attention layers a decode step runs: the shared block's
        applications for the hybrid, none for RWKV."""
        cfg = self.cfg
        if self.kind == "hybrid":
            return cfg.num_layers // cfg.shared_attn_period
        return 0 if self.kind == "rwkv" else cfg.num_layers

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def set_tp(self, tp, keep: bool = True) -> None:
        """Run on the model axis: ``tp`` (a ``TensorParallel``) after every
        parameter was placed (``launch.sharding.tp_shard``); the layers
        then compute on the local shards. With ``keep`` the no-grad paths
        (serving) read them kept here once, so a decode step pays no
        DTensor dispatch: each block's (decoder, encoder, Mamba2, RWKV6
        and the hybrid's shared block) by its parameter groups (an MoE
        block's ``moe`` tree nested as the reference's: ``shared`` under
        it), and the model's own. A graph (a train step) reads them live;
        without ``keep`` (an FSDP2-sharded model, ``training.trainer.
        fsdp_shard``) every path does."""
        self.tp = tp
        for block in self.modules():
            if isinstance(block, _Block):
                block.tp = tp
                block.shards = ({n: _local_tree(c)
                                 for n, c in block.named_children()}
                                if keep else None)
        self.shards = ({n: self._live(n) for n in _OWN
                        if n == "head" or getattr(self, n, None) is not None}
                       if keep else None)

    def _live(self, name: str):
        """A model-level parameter (group) of ``_OWN`` read now: its local
        shard on the model axis (the head: the tied embedding's
        transpose, or ``lm_head``), else the module's own."""
        if name == "head":
            return (local(self.embed).t() if self.lm_head is None
                    else local(self.lm_head))
        t = getattr(self, name)
        if isinstance(t, torch.Tensor):
            return local(t)
        return t if self.tp is None else _local_tree(t)

    def _own(self, name: str):
        """A model-level parameter (group) as ``_run`` computes on it:
        kept or live as ``_Block._part`` reads a block's."""
        if self.shards is None or torch.is_grad_enabled():
            return self._live(name)
        return self.shards[name]

    def hidden(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """The block stack over already-embedded x (B, S, d), positions
        0..S-1, in "train" mode (the reference's ``_apply_decoder``
        without a cache), each block checkpointed with ``remat``."""
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[0], -1)
        for block in self.blocks:
            x = _remat(block, remat)(x, positions)
        return x

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, Any]:
        """The decode cache (zeros); on the model axis placed by the
        tables (``launch.sharding.place_cache``), each rank allocating
        only its shard."""
        if self.tp is not None:
            return place_cache(self._cache_tree(batch, max_len, dtype,
                                                "meta"), self.tp)
        return self._cache_tree(batch, max_len, dtype,
                                self.device if device is None else device)

    def _cache_tree(self, batch: int, max_len: int, dtype, device
                    ) -> Dict[str, Any]:
        cfg = self.cfg
        cache: Dict[str, Any] = {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
        if cfg.pos_type == "mrope":
            cache["mrope_delta"] = torch.zeros((batch,), dtype=torch.int32,
                                               device=device)

        def stack(one: dict, n: int) -> dict:
            # ``one`` lives on the meta device: its shapes and dtypes only
            return {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                   device=device) for k, v in one.items()}

        def kv():
            mk = (attn.mla_cache_init if cfg.attn_type == "mla"
                  else attn.gqa_cache_init)
            return mk(cfg, batch, max_len, dtype, device="meta")
        kind = self.kind
        if kind == "audio":
            cache["self"] = stack(kv(), cfg.num_layers)
            cache["enc_out"] = torch.zeros(
                (batch, cfg.encoder_seq_len, cfg.d_model), dtype=dtype,
                device=device)
        elif kind == "hybrid":
            cache["mamba"] = stack(
                ssm_mod.mamba2_cache_init(cfg, batch, device="meta"),
                cfg.num_layers)
            cache["shared"] = stack(kv(), self.attn_applications)
        elif kind == "rwkv":
            cache["rwkv"] = stack(
                rwkv_mod.rwkv6_state_init(cfg, batch, device="meta"),
                cfg.num_layers)
        else:
            for group, n in (("dense", self.n_dense),
                             ("moe", cfg.num_layers - self.n_dense)):
                if n:
                    cache[group] = stack(kv(), n)
        return cache

    @staticmethod
    def _views(cache: Cache, group: str, j: int) -> Optional[dict]:
        """Entry j's views into a group's stacked leaves."""
        if cache is None:
            return None
        return {k: v[j] for k, v in cache[group].items()}

    @staticmethod
    def insert_slot(cache: Dict[str, Any], one: Dict[str, Any],
                    slot: int) -> None:
        """Copy a batch-1 cache ``one`` into batch row ``slot`` of
        ``cache`` in place: ``pos``, ``mrope_delta`` and ``enc_out`` have
        the batch on axis 0, the stacked leaves of every group of
        ``GROUPS`` on axis 1. Placed caches (the model axis) copy shard to
        shard: where the batch is split over the data axis, only the rank
        that holds ``slot`` writes it."""
        for k, v in cache.items():
            if k in GROUPS:
                for n, buf in v.items():
                    _insert(buf, one[k][n], slot, 1)
            else:
                _insert(v, one[k], slot, 0)

    # ----------------------------------------------------------------- apply
    def apply(self, tokens: torch.Tensor, *,
              vision_embeds: Optional[torch.Tensor] = None,
              encoder_frames: Optional[torch.Tensor] = None,
              cache: Cache = None, mode: str = "train", remat: bool = False,
              prompt_lengths: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """tokens: (B, S_text) int. Returns (logits, new_cache, aux).

        encoder_frames (B, S_enc, d): the audio family's frame embeddings,
        read in train and prefill (decode reads the cache's ``enc_out``).
        remat: checkpoint each layer body (train mode).
        prompt_lengths (B,): true prompt lengths (vision tokens included)
        for right-padded prefill — pad keys are masked, last-token logits
        and cache positions use the true length."""
        kw = dict(vision_embeds=vision_embeds, encoder_frames=encoder_frames,
                  cache=cache, mode=mode, remat=remat,
                  prompt_lengths=prompt_lengths)
        if mode == "train":
            return self._forward(tokens, **kw)
        with torch.no_grad():
            return self._forward(tokens, **kw)

    def _forward(self, tokens, *, vision_embeds, encoder_frames, cache,
                 mode, remat, prompt_lengths):
        tp = self.tp
        if tp is None or mode == "train":
            # train mode on the model axis: the caller gives this data
            # rank's rows (the trainer's batch) and takes its logits
            return self._run(tokens, vision_embeds=vision_embeds,
                             encoder_frames=encoder_frames, cache=cache,
                             mode=mode, remat=remat,
                             prompt_lengths=prompt_lengths)
        # serving on the model axis: this data rank's rows, the cache's
        # local shards; logits gathered whole, the new cache positions
        # placed again
        b = tokens.shape[0]
        placed = cache
        rows = None
        if cache is not None:
            cache = {k: ({n: local(t) for n, t in v.items()}
                         if k in GROUPS else local(v))
                     for k, v in cache.items()}
            # the attention groups' rows (the recurrent ones have none)
            rows = {g: _shard_rows(placed[g][leaf], tp)
                    for g in GROUPS if g in placed
                    for leaf in ("k", "ckv") if leaf in placed[g]}
        logits, new, aux = self._run(
            tp.batch_rows(tokens), vision_embeds=tp.batch_rows(vision_embeds),
            encoder_frames=tp.batch_rows(encoder_frames), cache=cache,
            mode=mode, remat=remat,
            prompt_lengths=tp.batch_rows(prompt_lengths), cache_rows=rows)
        logits = tp.gather_batch(logits, b)
        if new is None:
            return logits, None, aux
        out = dict(placed)
        for k in ("pos", "mrope_delta"):
            if k in new:
                out[k] = _rewrap(new[k], placed[k])
        return logits, out, aux

    def _run(self, tokens, *, vision_embeds, encoder_frames, cache,
             mode, remat, prompt_lengths, cache_rows=None):
        cfg = self.cfg
        dev = self.device
        tokens = tokens.to(dev)
        if prompt_lengths is not None:
            prompt_lengths = prompt_lengths.to(dev)
        cache_pos = cache["pos"] if cache is not None else None
        kv_lengths = prompt_lengths if mode == "prefill" else None
        cached_delta = (cache.get("mrope_delta") if cache is not None
                        else None)
        if vision_embeds is not None:
            vision_embeds = vision_embeds.to(dev)

        x, positions, mrope_positions, delta = self._embed(
            tokens, vision_embeds, cache_pos, cached_delta, mode)
        x = x.to(self.adtype)
        s_total = x.shape[1]                    # vision tokens included
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        kw = dict(positions=positions, cache_pos=cache_pos, mode=mode,
                  kv_lengths=kv_lengths)
        kind = self.kind
        rows = cache_rows or {}
        if kind == "audio":
            enc_out = self._encode(encoder_frames, cache, mode, remat)
            for i, block in enumerate(self.blocks):
                x = _remat(block.step, remat)(
                    x, cache=self._views(cache, "self", i), enc_out=enc_out,
                    cache_rows=rows.get("self"), **kw)[0]
        elif kind == "hybrid":
            period = cfg.shared_attn_period

            def superstep(x, j):
                # a group of Mamba2 layers, then the weight-tied block
                # with application j's cache
                for i in range(j * period, (j + 1) * period):
                    x = self.blocks[i].step(
                        x, self._views(cache, "mamba", i), mode)
                return self.shared.step(
                    x, cache=self._views(cache, "shared", j),
                    cache_rows=rows.get("shared"), **kw)[0]
            for j in range(self.attn_applications):
                x = _remat(superstep, remat)(x, j)
        elif kind == "rwkv":
            for i, block in enumerate(self.blocks):
                x = _remat(block.step, remat)(
                    x, self._views(cache, "rwkv", i), mode)
        else:
            for i, block in enumerate(self.blocks):
                group, j = (("dense", i) if i < self.n_dense
                            else ("moe", i - self.n_dense))
                x, _, a = _remat(block.step, remat)(
                    x, mrope_positions=mrope_positions,
                    cache=self._views(cache, group, j),
                    cache_rows=rows.get(group), **kw)
                if a is not None:
                    aux = aux + a

        x = _norm(cfg, self._own("final_norm"), x)
        if mode == "prefill":
            if prompt_lengths is not None:
                idx = (prompt_lengths - 1).to(torch.long)
                x = x[torch.arange(x.shape[0], device=dev), idx][:, None]
            else:
                x = x[:, -1:]
        head = self._own("head")
        if head.shape[1] < cfg.vocab_size:
            # the vocabulary's shards: x enters the rank's columns; the
            # logits, gathered whole, meet the same loss on every rank
            # (the backward takes the rank's columns)
            logits = self.tp.gather_model(model_copy(self.tp, x)
                                          @ head.to(x.dtype))
        else:
            logits = x @ head.to(x.dtype)
        if cache is None:
            return logits, None, aux
        b = tokens.shape[0]
        new_cache = dict(cache)
        if mode == "decode":
            new_cache["pos"] = cache_pos + 1
        elif prompt_lengths is not None:
            new_cache["pos"] = prompt_lengths.to(torch.int32)
        else:
            new_cache["pos"] = torch.full((b,), s_total, dtype=torch.int32,
                                          device=dev)
        if cfg.pos_type == "mrope":
            new_cache["mrope_delta"] = (
                cached_delta if mode == "decode"
                else torch.full((b,), delta, dtype=torch.int32, device=dev))
        return logits, new_cache, aux

    def _encode(self, encoder_frames, cache: Cache, mode: str,
                remat: bool = False) -> torch.Tensor:
        """The encoder's output in the activation dtype: at decode the
        cache's ``enc_out``; else the encoder over ``encoder_frames``
        (each block checkpointed with ``remat``), stored into the cache
        (in its dtype) at prefill."""
        if mode == "decode":
            return cache["enc_out"].to(self.adtype)
        assert encoder_frames is not None, "audio needs encoder_frames"
        e = encoder_frames.to(self.device, self.adtype)
        frames = torch.arange(e.shape[1], device=e.device)
        e = e + self._rows("enc_pos_embed", frames)[None]
        for block in self.enc_blocks:
            e = _remat(block.encode, remat)(e)
        e = _norm(self.cfg, self._own("enc_final_norm"), e)
        if cache is not None:
            cache["enc_out"].copy_(e)
        return e

    # ------------------------------------------------------------- internals
    def _rows(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the table ``name`` (``embed``, ``pos_embed``,
        ``enc_pos_embed``) in the activation dtype. A table split by its
        rows (the model axis) gives each rank's rows of its own ids,
        zeros elsewhere, summed over the ranks."""
        ids = ids.long()
        if self.tp is None:
            return getattr(self, name).to(self.adtype)[ids]
        tab = self._own(name)
        n = tab.shape[0]
        if n == self._table_rows(name):
            return tab[ids].to(self.adtype)
        ids = ids - self.tp.rank * n
        inside = ((ids >= 0) & (ids < n))[..., None]
        x = torch.where(inside, tab[ids.clamp(0, n - 1)], 0)
        return self.tp.all_reduce(x).to(self.adtype)

    def _table_rows(self, name: str) -> int:
        """The whole row count of the table ``name``."""
        cfg = self.cfg
        return {"embed": cfg.vocab_size, "pos_embed": cfg.max_seq_len,
                "enc_pos_embed": cfg.encoder_seq_len}[name]

    def _embed(self, tokens, vision_embeds, cache_pos, cached_delta, mode):
        cfg = self.cfg
        b = tokens.shape[0]
        x = self._rows("embed", tokens)
        if vision_embeds is not None and mode != "decode":
            x = torch.cat([vision_embeds.to(self.adtype), x], dim=1)
        s = x.shape[1]
        if mode == "decode":
            positions = cache_pos[:, None]                    # (B, 1)
        else:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        mrope_positions, delta = None, 0
        if cfg.pos_type == "mrope":
            mrope_positions, delta = self._mrope_positions(
                b, s, vision_embeds, cache_pos, cached_delta, mode,
                x.device)
        if cfg.pos_type == "learned":
            # a position past the table reads its last row, as the
            # reference's gather clamps it (before a split table masks)
            x = x + self._rows("pos_embed", positions.clamp(
                max=self.pos_embed.shape[0] - 1))
        return x, positions, mrope_positions, delta

    def _mrope_positions(self, b, s, vision_embeds, cache_pos, cached_delta,
                         mode, dev):
        """((3, B, S) position ids, rope delta). The delta (g − n_vision)
        maps absolute cache positions back onto the M-RoPE text axis at
        decode time (Qwen2-VL's rope_delta)."""
        nv = (vision_embeds.shape[1]
              if vision_embeds is not None and mode != "decode" else 0)
        if nv:
            g = math.isqrt(nv)
            assert g * g == nv, "vision_tokens must be a square grid"
            vi = torch.arange(nv, device=dev)
            ti = torch.arange(s - nv, device=dev) + g
            pos3 = torch.stack([
                torch.cat([torch.zeros_like(vi), ti]),
                torch.cat([vi // g, ti]),
                torch.cat([vi % g, ti])])                      # (3, S)
            return pos3[:, None].expand(3, b, s), g - nv
        if mode == "decode":
            # text continuation on the shifted M-RoPE text axis
            p = cache_pos + cached_delta                          # (B,)
            return p[None, :, None].expand(3, b, s), 0
        pos3 = torch.arange(s, device=dev)[None].expand(3, s)
        return pos3[:, None].expand(3, b, s), 0


def _insert(buf, one, slot: int, dim: int) -> None:
    """Batch row ``slot`` (on ``dim``) of ``buf`` ← ``one`` (batch 1), in
    place; a placed ``buf`` copies shard to shard, on the data rank that
    holds the row."""
    if not is_placed(buf):
        buf.narrow(dim, slot, 1).copy_(one)
        return
    lb, lo = local(buf), local(one)
    n = lb.shape[dim]
    r = buf.device_mesh.get_local_rank("data") if n < buf.shape[dim] else 0
    if r * n <= slot < (r + 1) * n:
        lb.narrow(dim, slot - r * n, 1).copy_(lo)


def _shard_rows(leaf, tp) -> Tuple[int, int]:
    """(lo, C): a placed (L, B, C, ...) cache leaf's local rows [lo, lo +
    its length) of its C rows (all of them unless split by sequence)."""
    c, cl = leaf.shape[2], local(leaf).shape[2]
    return (0 if cl == c else tp.rank * cl), c


def _rewrap(t: torch.Tensor, like):
    """``t`` (local) placed as ``like`` is (a ``LocalShard`` with no
    process group: the dry run's)."""
    if isinstance(like, LocalShard):
        return LocalShard(t, like.shape)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False)


def init_model(cfg: ModelConfig, seed: int = 0, device=None,
               mesh=None, mode: str = "serve") -> Transformer:
    """A ``Transformer`` with random weights from ``seed`` on ``device``
    (the reference's scales; not the reference's numbers — load those with
    ``core.convert.model_params_from_numpy``). ``mesh``: a ``("data",
    "model")`` ``DeviceMesh``; each block is placed on it as it is drawn
    (``launch.sharding``, by ``mode``'s table: "serve", or "train" for
    ``training.trainer.fsdp_shard`` to shard next), so the ranks hold the
    one-process model's weights, split by the tables."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    if mesh is None:
        return Transformer(cfg, gen)
    check_tp_family(cfg)
    tp = TensorParallel(mesh, device)
    model = Transformer(cfg, gen,
                        place=lambda m: place_params(m, tp, mode=mode))
    model.set_tp(tp)
    return model
