"""Answers against the reference, after the window, on a sample of the
requests the window finished, drawn from the seed with the one of most
tokens in it:

* ``logit_gap``: the reference (f32) runs once over each sampled
  request's vision tokens (made again from the frames its retrieval
  returned), prompt and served tokens; the number is the widest gap by
  which a served token's logit lies below the reference's best at its
  position (greedy decoding serves the best up to rounding);
* ``vision_gap``: the request's vision tokens as the program built
  them against the reference's, the largest difference over the
  reference's largest magnitude;
* ``query_gap``: the largest L2 distance between the query embeddings
  the program's text tower returned in the window (a sample) and the
  reference's;
* ``retrievals_differ``: over a sample of the window's questions, those
  whose frame ids differ from AKR's (``reference.retrieval``) run from
  the program's own state: the session's stored rows and members and
  the query embedding the program's text tower returned (held by
  ``query_gap``), with every earlier question of the session replayed
  on its key chain;
* ``memory.*``: that state itself, the memory the set-up's ticks
  filled, held to the reference as the ingest cell holds its own
  (``checks.ingest``: partitions, clusters and members, a sample of the
  stored rows against the reference's MEM embeddings of their index
  frames).

With ``control`` the reference a precision below takes the program's
place and its numbers are judged: the gap of the token it puts first at
each position (float8 operands), the vision tokens with bfloat16
operands, the query embeddings and the stored rows with float8
operands, the frame ids over int8 rows."""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from perfbench import weights
from perfbench.checks import ingest as ingest_check
from perfbench.harness import Check, compare
from perfbench.reference.decoder import DecoderReference
from perfbench.reference.layers import F32, Precision
from perfbench.reference.mem import MEMReference, patch_projection, patchify
from perfbench.reference.retrieval import Chain, akr_frame_ids
from perfbench.systems.venus_ingest import mem_shape
from perfbench.world import derive_seed

NAMES = ("logit_gap", "vision_gap", "query_gap", "retrievals_differ")


def sample_requests(tokens: List[int], min_tokens: int, seed: int
                    ) -> List[int]:
    """Indices: the request of most tokens, then others in the seed's
    order until ``min_tokens`` served tokens are in."""
    if not tokens:
        return []
    first = int(np.argmax(tokens))
    rng = np.random.default_rng(derive_seed("served-sample", seed))
    out, total = [first], tokens[first]
    for i in rng.permutation(len(tokens)):
        if total >= min_tokens:
            break
        if int(i) != first:
            out.append(int(i))
            total += tokens[int(i)]
    return out


def vision_tokens(world, sid: int, frame_ids, *, max_frames: int, patch: int,
                  n_tokens: int, d: int, device, prec: Precision = F32
                  ) -> torch.Tensor:
    """The request's vision tokens: its first ``max_frames`` retrieved
    frames patchified, cut or zero-padded to ``n_tokens`` rows."""
    out = torch.zeros((n_tokens, d), dtype=torch.float32, device=device)
    ids = np.asarray(frame_ids)[:max_frames]
    if len(ids) == 0:
        return out
    proj = prec.round(torch.from_numpy(patch_projection(patch, d)).to(device))
    frames = prec.round(world.frames(sid, ids))
    pe = patchify(frames, patch, proj).reshape(-1, d)[:n_tokens]
    out[:pe.shape[0]] = pe
    return out


def int8_rows(rows: np.ndarray) -> np.ndarray:
    """The program's int8 index path: each row rounded to 127 steps of
    its largest magnitude, then normalised again (as its scans do)."""
    scale = np.abs(rows).max(-1, keepdims=True) / 127.0
    q = np.rint(rows / np.where(scale > 0, scale, 1.0))
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)


def retrievals_differ(retrieval: dict, control: bool = False) -> int:
    """Sampled questions whose frame ids differ from the reference's,
    among those the reference does not find ambiguous; ``control``
    scans int8 rows (the program's own lower-precision index)."""
    vc = retrieval["memory"]
    want, used = {}, []
    by_k = {a["k"]: a for a in retrieval["asked"]}
    chains = {}
    for k, sid in enumerate(retrieval["order"]):
        chain = chains.setdefault(sid, Chain(vc["seed"]))
        sub = chain.next()
        a = by_k.get(k)
        if a is None:
            continue
        rows = retrieval["rows"][sid]
        emb = int8_rows(rows["emb"]) if control else rows["emb"]
        want[k] = akr_frame_ids(a["query"], emb, rows["members"], sub,
                                tau=vc["tau"], theta=vc["theta"],
                                beta=vc["beta"], n_max=vc["n_max"],
                                seed=vc["seed"])
        used.append(len(want[k][0]))
    clear = [k for k in by_k if not want[k][1]]
    print(f"retrievals ({'int8' if control else 'f32'} rows): {len(by_k)} "
          f"sampled, "
          f"{len(by_k) - len(clear)} ambiguous, frames a question "
          f"{np.mean(used) if used else 0:.2f}", file=sys.stderr)
    return sum(1 for k in clear if not np.array_equal(
        np.sort(by_k[k]["frame_ids"]), want[k][0]))


def readings(cfg: dict, mem_cfg: dict, world, sample: List[dict],
             queries: List[tuple], retrieval: dict, seed: int, device,
             traffic: dict, control: bool = False) -> dict:
    m = cfg
    d, nv = m["hidden_size"], m["vision_tokens"]
    kw = dict(max_frames=cfg["service"]["max_frames"],
              patch=mem_cfg["vision_config"]["patch_size"], n_tokens=nv, d=d,
              device=device)
    precs = (F32, Precision("fp8")) if control else (F32,)
    out = {k: 0.0 for k in NAMES}
    ctl = {k: 0.0 for k in NAMES}
    seqs, gaps, ctl_gaps = [], [], []
    for s in sample:
        ref = vision_tokens(world, s["sid"], s["frame_ids"], **kw)
        scale = float(ref.abs().max().clamp(min=1e-30))
        got = s["vision"].to(device)
        out["vision_gap"] = max(out["vision_gap"],
                                float((got - ref).abs().max()) / scale)
        if control:
            low = vision_tokens(world, s["sid"], s["frame_ids"],
                                prec=Precision("bf16"), **kw)
            ctl["vision_gap"] = max(ctl["vision_gap"],
                                    float((low - ref).abs().max()) / scale)
        gen = list(s["generated"])
        toks = np.concatenate([s["prompt"], np.asarray(gen[:-1], np.int64)])
        at = len(s["prompt"]) - 1 + np.arange(len(gen))
        seqs.append({"vision": ref, "tokens": toks, "at": at, "gen": gen})
    if seqs:
        from perfbench.systems.vlm_service import decoder_shape
        dec = DecoderReference(cfg, weights.provider(
            seed, cfg["name"], decoder_shape(m), device=device), device)
        for s, lg in zip(seqs, dec.logits(seqs, precs)):
            best = lg[0].max(-1).values
            gen = torch.as_tensor(s["gen"], device=device)
            gaps.append(best - lg[0].gather(-1, gen[:, None])[:, 0])
            if control:
                first = lg[1].argmax(-1)
                ctl_gaps.append(best - lg[0].gather(-1, first[:, None])[:, 0])
        for into, got in ((out, gaps), (ctl, ctl_gaps)):
            if got:
                into["logit_gap"] = float(torch.cat(got).max())
    if queries:
        rng = np.random.default_rng(derive_seed("query-sample", seed))
        n = min(traffic["check"]["sample_queries"], len(queries))
        pick = [queries[int(i)] for i in
                sorted(rng.choice(len(queries), n, replace=False))]
        get = weights.provider(seed, mem_cfg["name"], mem_shape(mem_cfg),
                               device=device)
        texts = [t for t, _ in pick]
        want = MEMReference(mem_cfg, get, device).encode_texts(texts)
        got = torch.from_numpy(np.stack([v for _, v in pick])).to(device)
        out["query_gap"] = float(torch.linalg.vector_norm(
            got - want, dim=-1).max())
        if control:
            low = MEMReference(mem_cfg, get, device,
                               Precision("fp8")).encode_texts(texts)
            ctl["query_gap"] = float(torch.linalg.vector_norm(
                low - want, dim=-1).max())
    out["retrievals_differ"] = retrievals_differ(retrieval)
    if control:
        ctl["retrievals_differ"] = retrievals_differ(retrieval, True)
    out["served_tokens"] = sum(len(s["gen"]) for s in seqs)
    out["control"] = ctl
    return out


def checks(cfg: dict, mem_cfg: dict, world, sample, queries, retrieval,
           seed: int, device, traffic: dict, control: bool = False
           ) -> List[Check]:
    r = readings(cfg, mem_cfg, world, sample, queries, retrieval, seed,
                 device, traffic, control)
    out = compare(cfg["limits"], {k: r[k] for k in NAMES},
                  r["control"] if control else None)
    out += ingest_check.checks(mem_cfg, traffic, world, retrieval["rows"],
                               traffic["memory_ticks"], seed, device,
                               control, prefix="memory.")
    # a window that finished no request, or asked no question, proves
    # nothing: its sample must hold the served tokens the traffic asks
    out.append(Check("served_tokens_short",
                     float(max(0, traffic["check"]["min_served_tokens"]
                               - r["served_tokens"])), 0.0))
    return out
