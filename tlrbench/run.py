"""Runs one benchmark cell once and prints its result as the last line:

    python3 tlrbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Exits non-zero, printing no result, when no
CUDA card is visible, when the checkout lacks the program, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``tlrbench``) and ``src/`` (the program) in
# place of this script's own directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from tlrbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
