"""Readings for a cell's limits: the program's numbers and its
control's, seed after seed in one process.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed is one run of the cell (set-up, a window at the cell's load,
the comparison) with the control in the program's place: the reference
in the precision just below the configuration's. Prints one JSON line a
seed: ``correct`` as the control's numbers decide it (it has to be
false), every number the control gives under its name, and the
program's own beside it under ``program.<name>``. The benchmark's own
runs never run the control.
"""

import time

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from perfbench import harness
    for seed in args.seeds:
        rec = harness.run_cell(args.workload, seed=seed, seconds=args.seconds,
                               trace=False, t_start=time.perf_counter(),
                               control=True)
        correct = all(c.ok for c in rec.checks if c.judged)
        print(json.dumps({"seed": seed, "correct": correct,
                          **{c.name: c.value for c in rec.checks}}),
              flush=True)
        del rec
    return 0


if __name__ == "__main__":
    sys.exit(main())
