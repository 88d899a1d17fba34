"""Median seconds a request waited from its submission (the start of
``VenusService.submit``) to the start of its prefill: the ``waited`` of
the program's ``engine.prefill`` spans."""

import statistics

from perfbench import program_spans

LAYER = "entry"
UNIT = "s"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "answer_tokens_per_s"


def read(rec):
    spans = program_spans.in_window(rec, "engine.prefill")
    return (statistics.median(s.attrs["waited"] for s in spans)
            if spans else None)
