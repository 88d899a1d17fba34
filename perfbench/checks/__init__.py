"""The comparisons that decide ``correct``: what the window produced
against the plain reference, each number beside its limit."""
