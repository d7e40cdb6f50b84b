#!/usr/bin/env python3
"""Run one cell of the port's benchmark (see ``bench/harness.py``):

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness

    harness.configure_caches()
    sys.exit(harness.main())
