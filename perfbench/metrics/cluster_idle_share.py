"""Share of the program's ``ingest.cluster`` spans (each tick's
clustering stage, ending in its last partition's read-back) in which no
operation of the program ran on the device."""

from perfbench import program_spans

LAYER = "ingest stages"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "ingest_frames_per_s"


def read(rec):
    return program_spans.idle_share(
        rec.trace, program_spans.in_window(rec, "ingest.cluster"))
