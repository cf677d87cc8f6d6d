"""Run one cell of the port's benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared with the reference, each beside
its limit, are the last lines of standard error. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, is where modules are found
sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
