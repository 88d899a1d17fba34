"""Tokens the engine generated in the window (first tokens of the
prefills and every decoded token), over the window's host-clock seconds,
from its start to the end of the step that crosses ``--seconds``."""

LAYER = "entry"
UNIT = "tokens/s"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = None


def read(rec):
    return rec.obs["tokens"] / rec.window_s
