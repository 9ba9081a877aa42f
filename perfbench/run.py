"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the cell
asks for; see perfbench/core.py.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402


ROOT = pathlib.Path(__file__).resolve().parent.parent
# Every build and kernel cache inside the checkout, at fixed paths: the
# program's nvcc libraries already go to build/torch_kernels there.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from perfbench import core

    # set-up counts the interpreter's own start
    sys.exit(core.main(t_start=T0 - core.process_age()))
