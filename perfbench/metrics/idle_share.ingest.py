"""Share of the traced window in which no operation of the program ran
on the device (the frame generator's stream left out)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "ingest_frames_per_s"


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s(rec.t0, rec.t1) / rec.window_s)
