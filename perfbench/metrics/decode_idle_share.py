"""Share of the program's ``engine.decode`` spans in which no operation
of the program ran on the device."""

from perfbench import program_spans

LAYER = "serving"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "answer_tokens_per_s"


def read(rec):
    return program_spans.idle_share(
        rec.trace, program_spans.in_window(rec, "engine.decode"))
