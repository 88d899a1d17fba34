"""Each cell's whole run on the CPU at a small size: the driver's loop,
the comparison that decides ``correct``, the metrics that a CPU run can
read; the control (the reference a precision below the configuration's
in the program's place) fails a limit; and a run with the timed path
broken underneath, an answer or a token altered where it is produced,
comes out not correct. The look for a card is skipped here: the
harness's ``run_cell`` is driven with ``device="cpu"``."""

import copy
import time

import numpy as np
import pytest

from perfbench import harness

MAN = harness.manifest()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and a
    served cell must finish requests inside its short window."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def mem_config():
    cfg = harness.load_json("configs", "venus-mem-large.json")
    small = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=2,
                 intermediate_size=128)
    cfg["text_config"].update(small, vocab_size=512,
                              max_position_embeddings=32)
    cfg["vision_config"].update(small, image_size=32, patch_size=8,
                                max_position_embeddings=16)
    cfg["projection_dim"] = 64
    cfg["memory"]["memory_capacity"] = 256
    return cfg


def vlm_config():
    cfg = harness.load_json("configs", "qwen2-vl-7b.json")
    cfg.update(num_hidden_layers=2, hidden_size=256, num_attention_heads=8,
               num_key_value_heads=2, head_dim=32, intermediate_size=512,
               vocab_size=512, vision_tokens=16, mrope_section=[4, 6, 6],
               max_position_embeddings=512, memory_config=mem_config())
    cfg["engine"].update(batch_slots=4, max_len=256)
    return cfg


def small_traffic(name: str):
    tr = harness.load_json("traffic", f"{name}.json")
    tr["cameras"].update(streams=2, resolution=32, chunk_frames=16,
                         scene_len=[6, 14])
    if "memory_ticks" in tr:
        tr["memory_ticks"] = 2
        tr["warmup"]["answer_tokens"] = 2
        tr["check"].update(sample_tokens=10**6, min_served_tokens=8,
                           sample_queries=8, sample_retrievals=64)
    if name == "describe-closed":
        tr["answer_tokens"].update(min=4, max=10, median=6)
    if name == "ingest-16cam":
        tr["check"]["sample_rows"] = 64
    return tr


# cell: (small configuration, traffic, window seconds: a served cell's
# window has to finish requests on a busy CPU)
CELLS = {"ingest-16cam-224": (mem_config, "ingest-16cam", 1.0),
         "qwen2vl-describe-closed": (vlm_config, "describe-closed", 3.0)}


def run(cell, control=False):
    make_cfg, traffic, seconds = CELLS[cell]
    return harness.run_cell(cell, seed=2**31 + 101, seconds=seconds,
                            trace=False, device="cpu",
                            t_start=time.perf_counter(), man=MAN,
                            cfg=make_cfg(), traffic=small_traffic(traffic),
                            control=control)


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_runs_correct_and_its_control_fails_a_limit(cell):
    rec = run(cell, control=True)
    out = harness.result(cell, rec, False, MAN, {"platform": "cpu"})
    # the control in the program's place: the run is not correct ...
    assert not out["correct"], out["compared"]
    # ... and the program's own numbers beside it are all within limits
    program = [c for c in rec.checks if not c.judged]
    assert program and all(c.ok for c in program), out["compared"]
    shared = [c for c in rec.checks
              if c.judged and f"program.{c.name}" not in out["compared"]]
    assert all(c.ok for c in shared), shared
    assert rec.attempted > 0 and rec.failed == 0
    names = {m["name"] for m in harness.metrics_for(cell, False, MAN)}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "compared"
    # the per-layer metrics a CPU run can read (not the device's)
    out = harness.result(cell, rec, True, MAN, {"platform": "cpu"})
    assert out["metrics"] and all(v["value"] > 0
                                  for v in out["metrics"].values())


# the served cell holds the memory its retrieval replays over as the
# ingest cell holds its own
@pytest.mark.parametrize("cell,name", [
    ("ingest-16cam-224", "embedding_gap"),
    ("qwen2vl-describe-closed", "memory.embedding_gap")])
def test_altered_embedding_is_caught(monkeypatch, cell, name):
    from repro_torch.core import pipeline
    inner = pipeline.MEMEmbedder.embed_frames

    def altered(self, frames, aux_texts=None, frame_ids=None):
        out = inner(self, frames, aux_texts, frame_ids=frame_ids)
        out[0] = -out[0]
        return out
    monkeypatch.setattr(pipeline.MEMEmbedder, "embed_frames", altered)
    rec = run(cell)
    bad = {c.name for c in rec.checks if not c.ok}
    assert name in bad


def test_altered_cluster_is_caught(monkeypatch):
    from repro_torch.core import session
    inner = session.cluster_stage

    def altered(*a, **kw):
        job = inner(*a, **kw)
        job.member_lists[0] = job.member_lists[0][:-1]
        return job
    monkeypatch.setattr(session, "cluster_stage", altered)
    rec = run("ingest-16cam-224")
    assert any(not c.ok for c in rec.checks
               if c.name in ("partitions_differ", "clusters_differ"))


def test_altered_token_is_caught(monkeypatch):
    from repro_torch.serving import engine
    inner = engine.ServingEngine._decode
    calls = []

    def altered(self, tokens):
        nxt = inner(self, tokens)
        calls.append(1)
        if len(calls) == 8:          # one token, in the window
            nxt[0] = (nxt[0] + 1) % self.cfg.vocab_size
        return nxt
    monkeypatch.setattr(engine.ServingEngine, "_decode", altered)
    rec = run("qwen2vl-describe-closed")
    bad = {c.name for c in rec.checks if not c.ok}
    assert "logit_gap" in bad


def test_altered_retrieval_is_caught(monkeypatch):
    from repro_torch.core import session
    inner = session.SessionManager.execute

    calls = []

    def altered(self, plan, **kw):
        res = inner(self, plan, **kw)
        calls.append(1)
        if len(calls) == 3:          # one answer, in the window
            res[0].frame_ids = np.asarray(res[0].frame_ids) + 1
        return res
    monkeypatch.setattr(session.SessionManager, "execute", altered)
    rec = run("qwen2vl-describe-closed")
    bad = {c.name for c in rec.checks if not c.ok}
    assert "retrievals_differ" in bad


def test_small_configs_keep_the_files_keys():
    for make, name in ((mem_config, "venus-mem-large"),
                       (vlm_config, "qwen2-vl-7b")):
        small = make()
        full = harness.load_json("configs", f"{name}.json")
        assert set(small) == set(full)
        assert copy.deepcopy(small)["limits"] == full["limits"]
