"""The whole ingest step's share of the card's bf16 peak: the
benchmark's count of MEM's operations for the frames embedded in the
window (the vision side; this cell embeds no aux text), over the window
and 989 TFLOP/s."""

from perfbench import counts

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "ingest_frames_per_s"


def read(rec):
    frames = sum(n for a, _, n in rec.obs["embed_calls"]
                 if rec.t0 <= a < rec.t1)
    flops = frames * counts.mem_frame_flops(rec.cfg)
    return 100.0 * flops / (rec.window_s * counts.PEAK_BF16_FLOPS)
