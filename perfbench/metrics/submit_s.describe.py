"""Seconds of the program's ``service.submit`` spans (plan, query
embedding, retrieval, vision tokens, enqueue) per question submitted
(their ``questions``)."""

from perfbench import program_spans

LAYER = "entry"
UNIT = "s"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "answer_tokens_per_s"


def read(rec):
    spans = program_spans.in_window(rec, "service.submit")
    n = sum(s.attrs["questions"] for s in spans)
    return sum(s.seconds for s in spans) / n if n else None
