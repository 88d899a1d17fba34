"""Seconds from the start of the process to the start of the window:
imports, the benchmark's weights and inputs, the program's set-up, the
memory a serving cell's traffic needs, the warm-up of every shape the
window uses (and the kernels' build on a checkout's first run)."""

LAYER = "entry"
UNIT = "s"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = None


def read(rec):
    return rec.setup_s
