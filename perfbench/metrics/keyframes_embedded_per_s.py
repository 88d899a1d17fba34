"""Index frames embedded over the seconds of the program's
``ingest.embed`` spans (one a committing tick, around the embedder's
call and its read-back; their ``keyframes``)."""

from perfbench import program_spans

LAYER = "models"
UNIT = "frames/s"
SOURCE = "program_span"
BETTER = "higher"
MOVES = "ingest_frames_per_s"


def read(rec):
    spans = program_spans.in_window(rec, "ingest.embed")
    secs = sum(s.seconds for s in spans)
    return (sum(s.attrs["keyframes"] for s in spans) / secs
            if secs > 0 else None)
