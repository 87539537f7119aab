#!/usr/bin/env python3
"""The benchmark of qinfer_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``BENCHMARK.json`` names the cells; see
``harness/runner.py`` for what a run prints. Every build and kernel cache
stays inside the checkout, under ``build/``.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for cache, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[cache] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [HERE, ROOT]

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
