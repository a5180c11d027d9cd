"""Run one cell of the benchmark of ``gym_anm_torch`` once, on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See ``harness/cli.py`` for what it prints.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every build and kernel cache inside the checkout, at fixed paths: the kernels
# themselves go to build/kernels/ (the port's own fixed directory).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT)]

if __name__ == "__main__":
    from harness.cli import main

    sys.exit(main(sys.argv[1:], T0))
