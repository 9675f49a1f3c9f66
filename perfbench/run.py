"""Run one cell of the benchmark once, on the machine this starts on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; the numbers that
decide ``correct`` are also the last lines of standard error.  Set-up is
timed from this file's first statement.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this file's folder, so that the program
# and the benchmark import from it and nothing here shadows a module
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
