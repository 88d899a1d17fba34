"""Mean seconds of a decode step in the window, as ``ServingEngine.
timings["decode"]`` keeps them (each ends in reading its tokens
back)."""

LAYER = "serving"
UNIT = "s"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "answer_tokens_per_s"


def read(rec):
    s = [t for st in rec.obs["steps"] if rec.t0 <= st["t0"] < rec.t1
         for t in st["decode_s"]]
    return sum(s) / len(s) if s else None
