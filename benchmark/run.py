"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and the numbers the check compared, with their limits, as the last lines
of standard error.  Exits non-zero, with no result, without the CUDA
devices the cell needs or outside a checkout of the repository.
"""

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
sys.path[0] = str(ROOT)

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
