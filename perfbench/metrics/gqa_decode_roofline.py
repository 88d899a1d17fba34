"""Kernel #5's share of its roofline in the window: for each decode
step that ran in it, one launch a layer over the requests decoding
(their q, their valid key and value rows at their real contexts, their
context written; bf16), over 3.35 TB/s, against the device time #5's
kernels (the split and merge kernels) cover in the trace. Nothing to
read when the trace's launches are not the window's steps × layers."""

from perfbench import counts

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "answer_tokens_per_s"


def read(rec):
    if rec.trace is None:
        return None
    m = rec.cfg
    steps = [s for s in rec.obs["steps"] if rec.t0 <= s["t0"]
             and s["t1"] <= rec.t1 and s["decode_s"]]
    launches, secs = rec.trace.kernel(
        ["k_gqa_split", "k_partial", "k_merge"], ["k_gqa_split", "k_partial"],
        rec.t0, rec.t1)
    if launches != len(steps) * m["num_hidden_layers"] or secs <= 0:
        return None
    least = sum(m["num_hidden_layers"] * counts.roofline_s(
        counts.gqa_decode_bytes(m, s["contexts"]),
        counts.gqa_decode_flops(m, s["contexts"])) for s in steps)
    return 100.0 * least / secs
