"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the port is imported from ``src/``.
The set-up's clock starts here, before anything is imported. Build and
kernel caches stay inside the checkout. The last line of standard output
is one JSON object; the numbers compared to decide ``correct`` are the
last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("perfbench: no src/repro_torch in this checkout",
              file=sys.stderr)
        return 2
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from perfbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
