"""Ingest against the reference, after the window, for every stream:

* ``partitions_differ``: the reference's closed scene partitions of the
  same frames whose scene the memory lacks or whose stored members fall
  outside the partition, and scenes the reference does not close
  (exact: limit 0);
* ``clusters_differ``: partitions whose clusters differ from the
  reference's clustering of the same frames: members exactly, the index
  frame among the members that tie for nearest the centroid (limit 0);
* ``embedding_gap``: over a sample of the stored rows drawn from the
  seed, the largest L2 distance between the row the program stored and
  the reference's f32 MEM embedding of its index frame (both unit
  rows).

With ``control`` the reference in the precision below the
configuration's (float8 operands) takes the program's place: its
``embedding_gap`` is judged, and its partitions and clusters, the
reference's own, differ in none."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.harness import Check, compare
from perfbench.reference.ingest import stream_clusters
from perfbench.reference.layers import Precision
from perfbench.reference.mem import MEMReference
from perfbench.systems.venus_ingest import mem_shape
from perfbench.world import derive_seed


def program_partitions(rows: dict) -> Dict[int, list]:
    """scene id → [(index frame, members), ...] in row order."""
    out: Dict[int, list] = {}
    for r, sc in enumerate(rows["scene_id"]):
        out.setdefault(int(sc), []).append(
            (int(rows["index_frame"][r]), tuple(sorted(rows["members"][r]))))
    return out


def structure(world, rows_by_sid: dict, n_chunks: int, vc: dict):
    """(partitions that differ, partitions whose clusters differ). A
    cluster of more than ``member_cap`` frames keeps a uniform sample of
    that many (the reservoir), so a stored row matches a reference
    cluster when its members are among the cluster's, as many as the
    cap allows, and its index frame is one the reference accepts."""
    cap = vc["member_cap"]
    bad_parts = bad_clusters = 0
    for s, rows in rows_by_sid.items():
        parts, clusters = stream_clusters(world, s, n_chunks, vc)
        prog = program_partitions(rows)
        bad_parts += len(set(prog) - set(range(len(parts))))
        for p, (a, b) in enumerate(parts):
            got = prog.get(p, [])
            if not got or any(f < a or f >= b for _, mem in got for f in mem):
                bad_parts += 1
                continue
            want = {m: (near, mem) for near, mem in clusters[p] for m in mem}
            ok = len(got) == len(clusters[p])
            for idx, mem in got:
                near, full = want.get(mem[0], ((), ()))
                ok = ok and (set(mem) <= set(full)
                             and len(mem) == min(len(full), cap)
                             and idx in near)
            bad_clusters += not ok
    return bad_parts, bad_clusters


def sample_rows(rows_by_sid: dict, n: int, seed: int) -> List[tuple]:
    """``n`` (stream, row) pairs drawn from the seed."""
    pairs = [(s, r) for s, rows in sorted(rows_by_sid.items())
             for r in range(len(rows["scene_id"]))]
    rng = np.random.default_rng(derive_seed("ingest-sample", seed))
    pick = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False)
    return [pairs[i] for i in sorted(pick)]


def embedding_gaps(cfg: dict, world, rows_by_sid: dict, pairs, seed: int,
                   device, precs=("f32",)) -> List[float]:
    """The largest distance between the stored rows at ``pairs`` and
    the f32 reference, and (for each further precision in ``precs``)
    between the reference in that precision and the f32 reference."""
    get = weights.provider(seed, cfg["name"], mem_shape(cfg), device=device)
    frames = torch.cat([world.frames(s, [rows_by_sid[s]["index_frame"][r]])
                        for s, r in pairs])
    want = MEMReference(cfg, get, device).encode_frames(frames)
    got = torch.from_numpy(np.stack([rows_by_sid[s]["emb"][r]
                                     for s, r in pairs])).to(device)
    out = [float(torch.linalg.vector_norm(got - want, dim=-1).max())]
    for p in precs[1:]:
        ctl = MEMReference(cfg, get, device, Precision(p)).encode_frames(
            frames)
        out.append(float(torch.linalg.vector_norm(ctl - want, dim=-1).max()))
    return out


def readings(cfg: dict, traffic: dict, world, rows_by_sid: dict,
             n_chunks: int, seed: int, device, precs=("f32",)) -> dict:
    parts, clusters = structure(world, rows_by_sid, n_chunks, cfg["memory"])
    pairs = sample_rows(rows_by_sid, traffic["check"]["sample_rows"], seed)
    gaps = embedding_gaps(cfg, world, rows_by_sid, pairs, seed, device, precs)
    return {"partitions_differ": parts, "clusters_differ": clusters,
            "embedding_gap": gaps[0], "control_gaps": gaps[1:]}


def checks(cfg: dict, traffic: dict, world, rows_by_sid: dict,
           n_chunks: int, seed: int, device, control: bool = False,
           prefix: str = "") -> List[Check]:
    """The three numbers against the configuration's limits, named
    ``<prefix><name>``."""
    r = readings(cfg, traffic, world, rows_by_sid, n_chunks, seed, device,
                 ("f32", "fp8") if control else ("f32",))
    names = ("partitions_differ", "clusters_differ", "embedding_gap")
    ctl = None
    if control:
        ctl = {"partitions_differ": 0.0, "clusters_differ": 0.0,
               "embedding_gap": r["control_gaps"][0]}
    return compare(cfg["limits"], {k: r[k] for k in names}, ctl, prefix)
