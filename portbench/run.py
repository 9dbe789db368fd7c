"""Run one cell of the port's benchmark once; the last line of standard
output is the result, one JSON object.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program is ``src/repro_torch``. Build
and kernel caches stay inside the checkout (the kernels' nvcc builds under
``build/repro_torch_kernels/``, the program's own choice; torch extensions
and Triton under ``build/portbench/``).
"""
import time

T0 = time.perf_counter()    # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench.core.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
