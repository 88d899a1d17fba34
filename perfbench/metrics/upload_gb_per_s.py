"""Bytes of the camera chunks over the seconds of the program's
``ingest.upload`` spans (a chunk archived and copied from pageable host
memory to the device, a copy the host waits for), in 1e9 bytes a
second."""

from perfbench import program_spans

LAYER = "ingest stages"
UNIT = "GB/s"
SOURCE = "program_span"
BETTER = "higher"
MOVES = "ingest_frames_per_s"


def read(rec):
    spans = program_spans.in_window(rec, "ingest.upload")
    secs = sum(s.seconds for s in spans)
    return (sum(s.attrs["bytes"] for s in spans) / secs / 1e9
            if secs > 0 else None)
