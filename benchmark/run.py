"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's notes and, last, each compared number beside its limit on
standard error, and one JSON result line last on standard output. See
``benchmark/README.md``.
"""

import os
import sys
import time


def process_age() -> float:
    """Seconds since this process started (from /proc), so that the set-up
    time counts the interpreter's start and every import."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - process_age()
BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.env_for_run()
    sys.exit(harness.run_cell(harness.parse_args(), T_PROCESS))
