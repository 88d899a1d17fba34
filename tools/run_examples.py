"""Run the port's four examples (``examples/torch_*.py``) one after the
other, each in its own process, and print each one's exit code and wall
seconds; exit 1 if any failed.

  python3 tools/run_examples.py            # on the card (their default)
  python3 tools/run_examples.py --device cpu

Their outputs go to ``chiprun_out/examples/<name>.log``.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_quickstart", "torch_online_video_qa",
            "torch_serve_batch", "torch_train_mem")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    out_dir = os.path.join(HERE, "chiprun_out", "examples")
    os.makedirs(out_dir, exist_ok=True)
    extra = ["--device", args.device] if args.device else []
    bad = 0
    for name in EXAMPLES:
        log = os.path.join(out_dir, name + ".log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, os.path.join(HERE, "examples",
                                              name + ".py"), *extra],
                stdout=f, stderr=subprocess.STDOUT, cwd=HERE).returncode
        wall = time.perf_counter() - t0
        bad += rc != 0
        print(f"{name}: exit {rc}, {wall:.2f} s wall "
              f"(device {args.device or 'cuda'})", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
