"""ldbench: the benchmark of weightedld_tpu_torch, one run of one cell.

    python3 ldbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, the
``ldbench/`` directory and the ``weightedld_tpu_torch`` package.  See
``ldbench/harness/main.py`` for what a run does and prints.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache inside the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / ".ldbench_cache" / sub))
sys.path.insert(0, str(ROOT))

from ldbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
