"""Run one cell of ``BENCHMARK.json`` once on the card and print its result:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON; the numbers that decide ``correct`` are the last lines of
standard error.  Build caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "h100bench", "_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)

from h100bench import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(sys.argv[1:], T_START))
