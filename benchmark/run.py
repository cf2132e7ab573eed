"""Run one benchmark cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (see ``harness.py``), or
exits non-zero with no result where there is no card, too few cards, no
program in the checkout, or JAX loaded.  ``--list`` prints the cells,
configurations and metrics found.
"""

import time

T0 = time.time()  # set-up counts from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)  # the checkout root, not this folder, is where modules come from
sys.path.insert(0, str(HERE.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
