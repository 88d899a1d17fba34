"""Drivers: one per kind of load. ``run(cfg, traffic, *, seed, seconds,
trace, device, t_start)`` builds, warms, runs the window and the
comparison, and returns a ``harness.Record``."""
