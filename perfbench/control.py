"""Run a cell's control: the configuration's reference with one broken
guarantee (its ``control_advance``) in the program's place, through the
rest of a run, and print what the comparison reads on each seed.  The
control has to come out not correct.

    python3 perfbench/control.py --workload life.board-16k --seeds 1,2,3 --seconds 1

A tool for setting a cell's limits from both readings, on the card at the
cell's own size; the benchmark's runs never call it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench.harness import run_cell  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": r["correct"], "checks": r["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
