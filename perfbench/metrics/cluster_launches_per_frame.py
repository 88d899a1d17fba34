"""Device operations that start inside the program's ``ingest.partition``
spans (one a closed partition, from stacking its frames to reading its
assignments back), per frame those partitions clustered (the spans'
``frames``)."""

from perfbench import program_spans

LAYER = "ingest stages"
UNIT = "ops"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "ingest_frames_per_s"


def read(rec):
    spans = program_spans.in_window(rec, "ingest.partition")
    frames = sum(s.attrs["frames"] for s in spans)
    return (program_spans.ops_started(rec.trace, spans) / frames
            if frames else None)
