"""Timing of variants of the trace kernel against each other, in turns, on
one NVIDIA GPU, with every variant's sums held against the checkout's
kernel bit for bit.

    python3 tools/trace_ab.py [--source NAME=PATH ...] [--set NAME:CONST=V[,CONST=V]] \
        [--rounds 4] [--cases a,b,...] [--out PATH]

Builds, each into its own library under build/trace_ab/, one nvcc per
variant, all started together, with the flags of ``ops/_build.py``:

* ``as_built``: ``raytracingdiffusioncurves_torch/csrc/trace.cu`` as it is;
* every ``--set NAME:CONST=V``: the same source with ``constexpr int CONST``
  set to V (for example ``no_keep:KEEP=0`` or ``six_blocks:MIN_BLOCKS=6``);
* every ``--source NAME=PATH``: another trace.cu (for example an earlier
  revision, unpacked with ``git show REV:raytracingdiffusioncurves_torch/csrc/trace.cu``).
  A source whose C entry takes the scene tables ``seg_consts`` and
  ``shade_all_t`` (the revisions before the packed records) is given those;
  the others the records.  A source whose C entry takes no ``tab_wedges``
  (the revisions before wedge coarsening) is called without it: every case
  launches fine tables.

Cases, each one launch at the shape its path gives it (``--cases`` picks
some): ``denoiser_off`` (seeded scene, 1024^2, 128 rpp, lists narrowed to
the largest count), ``denoised`` (1920x1088, 8 rpp), ``dense`` (the
lady_bug-class scene, 1920x1088, 256 rpp), ``dolphin`` (64 rpp),
``dense_8rpp`` (two wedges), ``chunk_kind`` (256^2, 512 rpp, chunk lists
alone: the tables of wedge shift 0), ``portal`` (256^2, 32 rpp, full sweep and bounces).  Per round the
variants in order, then in reverse in the next, so that a drift of the
card's clocks falls on all alike; each time is the mean of a few launches
between CUDA events.  Every variant's sums must equal ``as_built``'s bit
for bit (exit code 1 otherwise, after the timings).

Prints one line per case (each variant's times per round and median), one
per variant (registers and blocks per SM of its instantiations, where it has
``rtdc_trace_info``), the card's name and power limit, and writes everything
as JSON to ``--out`` (default build/trace_ab/result.json).  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if not torch.cuda.is_available():
    print("trace_ab: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
    sys.exit(2)

import raytracingdiffusioncurves_torch as rt  # noqa: E402
from raytracingdiffusioncurves_torch.ops import _build, trace_cuda  # noqa: E402
from raytracingdiffusioncurves_torch.utils.scenes import (  # noqa: E402
    dense_scene_xml,
    portal_weights_scene_xml,
    seeded_scene_xml,
)

OUT_DIR = ROOT / "build" / "trace_ab"
CASES = ("denoiser_off", "denoised", "dense", "dolphin", "dense_8rpp", "chunk_kind", "portal")
# Index, among rtdc_trace_sums' arguments after the two record pointers, of
# the tables' wedge count (launch_args' order).
TAB_WEDGES_ARG = 25
INFO_KEYS = ("registers", "local_bytes", "static_smem_bytes", "dynamic_smem_bytes",
             "blocks_per_sm", "block_threads")


def variant_sources(extra: list[str], sets: list[str]) -> dict[str, str]:
    src = (_build.CSRC / "trace.cu").read_text()
    out = {"as_built": src}
    for item in sets:
        name, _, assigns = item.partition(":")
        text = src
        for assign in assigns.split(","):
            const, _, value = assign.partition("=")
            pat = re.compile(rf"constexpr int {re.escape(const)} = [^;]+;")
            if not name or not value or len(pat.findall(text)) != 1:
                raise SystemExit(f"--set wants NAME:CONST=V with one 'constexpr int CONST', "
                                 f"got {item!r}")
            text = pat.sub(f"constexpr int {const} = {value};", text)
        out[name] = text
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
        cmd = [_build._nvcc(), *_build.nvcc_flags("trace"), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, text)
    libs = {}
    for name, (proc, path, text) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas:{name}] {line.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in _build.SIGNATURES["trace"].items():
            if fn == "rtdc_trace_sums" and not coarse(text):
                argtypes = argtypes[:TAB_WEDGES_ARG + 2] + argtypes[TAB_WEDGES_ARG + 3:]
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def coarse(source: str) -> bool:
    """Whether a trace.cu's C entry takes the tables' wedge count."""
    return "int tab_wedges" in source


def info(lib) -> list[dict] | None:
    if not hasattr(lib, "rtdc_trace_info"):
        return None
    rows = []
    for i in range(lib.rtdc_trace_info(-1, None)):
        vals = (ctypes.c_int * len(INFO_KEYS))()
        if lib.rtdc_trace_info(i, vals) != 0:
            raise RuntimeError("rtdc_trace_info failed")
        rows.append(dict(zip(INFO_KEYS, vals)))
    return rows


def case(name: str):
    """(scene, camera, config, tables, n_px, launches per timing)."""
    cam = rt.Camera()
    if name == "denoiser_off":
        scene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, 1024, 1024)))
        cfg = rt.RenderConfig(rays_per_pixel=128, rays_per_block=2048, use_denoiser=False)
        tables = rt.build_cand_tables(scene, cam, cfg)
        tables = trace_cuda.narrow_cand_tables(tables, rt.seg_max_count(scene, tables))
        return scene, cam, cfg, tables, 1024 * 1024, 10
    if name == "denoised":
        scene = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, 1920, 1088)))
        cfg = rt.RenderConfig(rays_per_pixel=8)
        tables = rt.build_cand_tables(scene, cam, cfg)
        tables = trace_cuda.narrow_cand_tables(tables, rt.seg_max_count(scene, tables))
        return scene, cam, cfg, tables, 1920 * 1088, 10
    if name in ("dense", "dolphin", "dense_8rpp"):
        kind = "dolphin" if name == "dolphin" else "lady_bug"
        rpp = {"dense": 256, "dolphin": 64, "dense_8rpp": 8}[name]
        scene = rt.build_device_scene(rt.load_scene_from_string(dense_scene_xml(0, 1920, 1088, kind)))
        cfg = rt.RenderConfig(rays_per_pixel=rpp)
        return scene, cam, cfg, rt.build_cand_tables(scene, cam, cfg), 1920 * 1088, 3
    if name == "chunk_kind":
        scene = rt.build_device_scene(rt.load_scene_from_string(dense_scene_xml(0, 256, 256)))
        cfg = rt.RenderConfig(rays_per_pixel=512, use_denoiser=False)
        return scene, cam, cfg, rt.build_cand_tables(scene, cam, cfg, wedge_shift=0), 256 * 256, 3
    if name == "portal":
        scene = rt.build_device_scene(rt.load_scene_from_string(portal_weights_scene_xml(256, 256)))
        cfg = rt.RenderConfig(rays_per_pixel=32, rays_per_block=2048, use_denoiser=False)
        return scene, cam, cfg, None, 256 * 256, 10
    raise SystemExit(f"unknown case {name!r}; cases: {', '.join(CASES)}")


def launcher(lib, records: bool, coarse: bool, scene, cam, cfg, tables, n_px):
    a, b = ((scene.walk_records, scene.shade_records) if records
            else (scene.seg_consts, scene.shade_all_t))
    out = torch.empty((5, n_px), dtype=torch.float32, device=scene.device)
    args = trace_cuda.launch_args(scene, cam, cfg, 0, 0, n_px, tables, out)
    if not coarse:
        if args[TAB_WEDGES_ARG] != args[TAB_WEDGES_ARG - 1]:
            raise RuntimeError("a source without wedge coarsening cannot read coarse tables")
        args = args[:TAB_WEDGES_ARG] + args[TAB_WEDGES_ARG + 1:]

    def run():
        err = lib.rtdc_trace_sums(a.data_ptr(), b.data_ptr(), *args)
        if err != 0:
            raise RuntimeError(f"launch failed: {_build.error_string(lib, err)}")
        return out

    return run


def time_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--set", action="append", default=[], dest="sets")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--out", default=str(OUT_DIR / "result.json"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sources = variant_sources(args.source, args.sets)
    libs = build(sources)
    names = list(libs)
    result = {"card": smi, "variants": {}, "cases": {}}
    for n in names:
        result["variants"][n] = {"records": "walk_records" in sources[n],
                                 "coarse": coarse(sources[n]), "info": info(libs[n])}
        print(f"[trace_ab:variant:{n}] records={result['variants'][n]['records']} "
              f"info={json.dumps(result['variants'][n]['info'])}", flush=True)
    failed = []
    for cname in args.cases.split(","):
        scene, cam, cfg, tables, n_px, reps = case(cname)
        runs = {n: launcher(libs[n], result["variants"][n]["records"],
                            result["variants"][n]["coarse"], scene, cam, cfg, tables, n_px)
                for n in names}
        ref = runs["as_built"]().clone()
        equal = {}
        for n in names:
            got = runs[n]()
            torch.cuda.synchronize()
            equal[n] = int((got != ref).any(dim=0).sum())
            if equal[n]:
                failed.append(f"{cname}:{n}: {equal[n]} pixels differ from as_built")
        times = {n: [] for n in names}
        for r in range(args.rounds):
            for n in names if r % 2 == 0 else names[::-1]:
                times[n].append(time_ms(runs[n], reps))
        med = {n: statistics.median(t) for n, t in times.items()}
        result["cases"][cname] = {"ms": times, "median_ms": med, "differing_pixels": equal,
                                  "launches_per_timing": reps, "n_sub": scene.n_sub,
                                  "rpp": cfg.rays_per_pixel}
        print(f"[trace_ab:{cname}] " + " ".join(
            f"{n}_ms={med[n]:.3f}({','.join(f'{t:.3f}' for t in times[n])})"
            f"{'' if not equal[n] else f' {n}_differing={equal[n]}'}" for n in names), flush=True)
        del runs, ref, scene, tables
        torch.cuda.empty_cache()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    if failed:
        print("trace_ab: " + "; ".join(failed), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
