"""The comparison's control and its readings, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3 [--program]

For each seed, one run of the cell as the benchmark runs it, except that the
reference computed a precision lower (``reference/frame.py``'s CONTROL:
float32 stages in bf16, the UNet's operands in fp8 e4m3) takes the
program's place in the comparison.  The comparison has to find it not
correct.  ``--program`` runs the program itself instead (the lower
readings).  Prints one JSON line per seed with the compared numbers.  The
benchmark's own runs never run this.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    import argparse
    import json

    import torch

    from perfbench import core

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    mode = "program" if args.program else "control"
    for seed in (int(s) for s in args.seeds.split(",")):
        out = core.run(cell, seed, args.seconds, False, "cuda", mode=mode)
        print(json.dumps({"workload": cell.name, "mode": mode, "seed": seed,
                          "correct": out["correct"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
