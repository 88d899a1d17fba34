"""Device operations that start inside the program's ``engine.decode``
spans (one a decode step, from the step's tokens uploaded to the next
tokens read back), per step."""

from perfbench import program_spans

LAYER = "serving"
UNIT = "ops"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "answer_tokens_per_s"


def read(rec):
    spans = program_spans.in_window(rec, "engine.decode")
    return (program_spans.ops_started(rec.trace, spans) / len(spans)
            if spans else None)
