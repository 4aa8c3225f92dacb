"""Run one cell of BENCHMARK.json once on the CUDA card(s) of this machine:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the compared numbers beside their limits
as the last lines on standard error and one JSON result line as the last
line on standard output. Exits with 2, printing no result, without the
card(s) the cell needs; with 3 if a module of JAX or of the JAX package was
loaded. Kernel libraries and caches stay in build/ inside the checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(BENCH), str(ROOT)]

if __name__ == "__main__":
    from harness.main import main
    sys.exit(main(t_start=T_START))
