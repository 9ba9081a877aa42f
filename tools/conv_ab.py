"""Timing of variants of the convolution kernel against each other, in turns,
on one NVIDIA GPU.

    python3 tools/conv_ab.py [--source NAME=PATH ...] [--rounds 4] [--reps 20] [--out PATH]

Builds, each into its own library under build/conv_ab/, one nvcc per
variant, all started together:

* ``as_built``: ``raytracingdiffusioncurves_torch/csrc/conv3x3.cu`` as it is;
* ``no_three_blocks``: the same source with the three-block register bound
  off, so the NP 48 and 96 tiles at stride 1 are built with
  ``__launch_bounds__(128)`` alone, as every other tile is;
* every ``--source NAME=PATH``: another conv3x3.cu with the same C entry
  (for example an earlier revision, unpacked with ``git show``).

Then, on the same seeded inputs, it times each variant on the nine UNet
layers at 1920x1088, ``conv3x3_same``'s 544x960 44->96 and the 28->28 layer
of ``weights/denoiser.msgpack``'s CNN at 1920x1088: per round the variants
in order, then in reverse in the next (A B, B A, ...), so that a drift of
the card's clocks falls on all alike.  Each time is the mean of ``--reps``
calls between CUDA events.  Every variant's output must equal
``as_built``'s bit for bit, and ``as_built``'s must hold the bars of
``chip_smoke.py`` against the plain version.

Prints one line per shape (each variant's times per round), one per variant
(the sums of the nine UNet layers per round; registers of each
instantiation), the card's name and power limit, and writes everything as
JSON to ``--out`` (default build/conv_ab/result.json).  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if not torch.cuda.is_available():
    print("conv_ab: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
    sys.exit(2)

from chip_smoke import conv_close, unet_layers  # noqa: E402
from raytracingdiffusioncurves_torch.ops import _build, conv_cuda  # noqa: E402

OUT_DIR = ROOT / "build" / "conv_ab"
BOUND_LINE = "static constexpr bool THREE_BLOCKS = S == 1 && WM * NT == 24;"


def variant_sources(extra: list[str]) -> dict[str, str]:
    src = (_build.CSRC / "conv3x3.cu").read_text()
    if src.count(BOUND_LINE) != 1:
        raise RuntimeError("conv3x3.cu no longer holds the three-block trait this tool turns off")
    out = {"as_built": src,
           "no_three_blocks": src.replace(BOUND_LINE, "static constexpr bool THREE_BLOCKS = false;")}
    for item in extra:
        name, _, path = item.partition("=")
        if not name or not path or name in out:
            raise SystemExit(f"--source wants a new NAME=PATH, got {item!r}")
        out[name] = (ROOT / path).read_text()
    return out


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = OUT_DIR / f"{name}.cu", OUT_DIR / f"lib{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.nvcc_flags("conv3x3"), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        (OUT_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"build of variant {name} failed:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in _build.SIGNATURES["conv3x3"].items():
            if hasattr(cdll, fn):
                getattr(cdll, fn).argtypes = argtypes
                getattr(cdll, fn).restype = restype
        libs[name] = cdll
    return libs


def use(lib: ctypes.CDLL) -> None:
    """Route conv_cuda.conv3x3 through ``lib`` from here on."""
    _build._LIBS["conv3x3"] = lib


def shapes(gen):
    """(name, inputs, kernels, bias, stride, relu, upsample) on the card."""
    bf = torch.bfloat16
    rows = unet_layers(1088, 1920) + [
        ("conv3x3_same", 544, 960, (44,), 96, 1, True, (False,)),
        ("cnn_28", 1088, 1920, (28,), 28, 1, True, (False,)),
    ]
    out = []
    for name, h, w, cins, cout, stride, relu, ups in rows:
        xs = [torch.randn((h >> int(u), w >> int(u), c), generator=gen, device="cuda").to(bf)
              for c, u in zip(cins, ups)]
        ks = [(torch.randn((3, 3, c, cout), generator=gen, device="cuda") * 0.1).to(bf)
              for c in cins]
        b = (torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(bf)
        out.append((name, xs, ks, b, stride, relu, ups))
    return out


def mean_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=OUT_DIR / "result.json")
    args = ap.parse_args()

    libs = build(variant_sources(args.source))
    names = list(libs)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = shapes(gen)

    registers = {}
    for name in names:
        use(libs[name])
        if hasattr(libs[name], "rtdc_conv3x3_info"):
            registers[name] = {f"np{i['np']}_s{i['stride']}": i["registers"]
                               for i in conv_cuda.kernel_instances()}

    # Outputs: as_built against the plain version, every variant against as_built.
    for case, xs, ks, b, stride, relu, ups in cases:
        use(libs["as_built"])
        ref = conv_cuda.conv3x3(xs, ks, b, stride, relu, ups)
        conv_close(conv_cuda.conv3x3_plain(xs, ks, b, stride, relu, ups), ref, b)
        for name in names[1:]:
            use(libs[name])
            got = conv_cuda.conv3x3(xs, ks, b, stride, relu, ups)
            if not torch.equal(got, ref):
                raise RuntimeError(f"variant {name} differs from as_built on {case}")

    times = {name: {case[0]: [] for case in cases} for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            use(libs[name])
            for case, xs, ks, b, stride, relu, ups in cases:
                fn = lambda: conv_cuda.conv3x3(xs, ks, b, stride, relu, ups)  # noqa: E731
                fn()
                times[name][case].append(mean_ms(fn, args.reps))

    unet = [row[0] for row in unet_layers(1088, 1920)]
    for case, *_ in cases:
        print(f"[conv_ab:{case}] " + " ".join(
            f"{n}=" + ",".join(f"{t:.4f}" for t in times[n][case]) for n in names), flush=True)
    sums = {n: [sum(times[n][c][r] for c in unet) for r in range(args.rounds)] for n in names}
    for n in names:
        print(f"[conv_ab:{n}] unet_sum_ms=" + ",".join(f"{t:.4f}" for t in sums[n])
              + f" registers={registers.get(n)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = dict(card=smi, rounds=args.rounds, reps=args.reps, order=names, ms=times,
                  unet_sum_ms=sums, registers=registers)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": True, "unet_sum_ms": {n: min(v) for n, v in sums.items()}}), flush=True)


if __name__ == "__main__":
    main()
