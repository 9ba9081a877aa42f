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


def _process_age() -> float:
    """Seconds since this process started (Linux), so that set-up counts
    the interpreter's own start."""
    try:
        start_ticks = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


ROOT = pathlib.Path(__file__).resolve().parent.parent
# Every build and kernel cache inside the checkout, at fixed paths: the
# program's nvcc libraries already go to build/torch_kernels there.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from perfbench import core

    sys.exit(core.main(t_start=T0 - _process_age()))
