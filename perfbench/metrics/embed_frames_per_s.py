"""Frames the MEM embedder was given over the seconds spent in its
calls inside the window (the harness's span around the embedder object
it hands to the manager; each call ends in a device-to-host read)."""

LAYER = "models"
UNIT = "frames/s"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "ingest_frames_per_s"


def read(rec):
    calls = [c for c in rec.obs["embed_calls"] if rec.t0 <= c[0] < rec.t1]
    secs = sum(b - a for a, b, _ in calls)
    return sum(n for _, _, n in calls) / secs if secs > 0 else None
