"""Kernel #2's share of its roofline in the window: the least bytes of
the chunks it scored (each camera's chunk a tick and the frame before
it, read once; φ written), over 3.35 TB/s, against the device time its
kernels cover in the trace. Nothing to read when the trace's launches
are not the window's ticks × cameras."""

from perfbench import counts

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "ingest_frames_per_s"


def read(rec):
    if rec.trace is None:
        return None
    o = rec.obs
    launches, secs = rec.trace.kernel(["k_scene"], ["k_scene_sum"],
                                      rec.t0, rec.t1)
    if launches != len(o["ticks"]) * o["streams"] or secs <= 0:
        return None
    b = launches * counts.scene_score_bytes(o["chunk"], o["resolution"],
                                            o["resolution"])
    return 100.0 * counts.roofline_s(b) / secs
