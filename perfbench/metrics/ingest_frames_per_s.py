"""Frames ingested a second: every camera's chunk of every tick of the
window (scored, segmented, clustered, index frames embedded and
inserted), over the window's host-clock seconds, from the first tick's
start to the end of the tick that crosses ``--seconds``."""

LAYER = "entry"
UNIT = "frames/s"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = None


def read(rec):
    return rec.obs["frames"] / rec.window_s
