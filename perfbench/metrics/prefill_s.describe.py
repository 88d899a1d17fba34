"""Median seconds of the program's ``engine.prefill`` spans (one an
admitted request: its batch-1 prefill, the insert into its slot and its
first token read back)."""

import statistics

from perfbench import program_spans

LAYER = "serving"
UNIT = "s"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "answer_tokens_per_s"


def read(rec):
    spans = program_spans.in_window(rec, "engine.prefill")
    return statistics.median(s.seconds for s in spans) if spans else None
