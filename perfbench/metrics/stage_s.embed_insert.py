"""Seconds the window's ticks spent in ``ingest_tick``'s ``embed_insert``
stage, summed over the ticks, as the program returns them (each stage
ends in a device-to-host read, so its device work is inside)."""

LAYER = "ingest stages"
UNIT = "s"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "ingest_frames_per_s"


def read(rec):
    return sum(t["embed_insert"] for t in rec.obs["ticks"])
