#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout; see ``harness/main.py``.  Exits 2 without
the CUDA devices the cell needs or without the program under test
(``float_torch``), 3 if the run loaded JAX or the JAX package."""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - _process_age()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [HERE, ROOT]

if __name__ == "__main__":
    from pathlib import Path

    from harness.main import main
    sys.exit(main(sys.argv[1:], Path(ROOT), T_PROCESS))
