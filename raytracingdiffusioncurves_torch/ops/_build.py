"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: a build takes
seconds, not minutes).  Libraries land in ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once.  ``build_all``
starts one nvcc per source, all at once.  A failed build raises with the
compiler's output.

Flags: ``sm_90a`` (Hopper) and no fast math for every source; IEEE division
and square root are nvcc's defaults; ``-Xptxas -v`` writes each kernel's
registers, shared memory and spills to the build log.  Each source adds its
own flags (``SOURCE_FLAGS``): the trace, bilateral and blur kernels build
with ``--fmad=false`` so that every multiply and add rounds on its own, as
in their plain PyTorch versions; the convolution's products are exact in
float32 and summed by the tensor cores, so it needs no flag of its own.

This module is imported only by code that launches a kernel: the CPU tests
never need nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
COMMON_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Flags of one source only, by its stem.
SOURCE_FLAGS = {
    "trace": ["--fmad=false"],
    "conv3x3": [],
    "bilateral": ["--fmad=false"],
    "blur": ["--fmad=false"],
}

# ctypes signatures of each library's C entry points.
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "trace": {
        "rtdc_trace_sums": (
            [_P, _P, _I, _I,  # walk_records, shade_records, s_pad, n_sub
             _P, _P, _I,  # cand ids, cand counts, cand_len
             _P, _P,  # cand lbs, cand horizon
             _P, _P, _P, _I,  # chunk ids, chunk lbs, chunk counts, chunk_slots
             _P, _P,  # scene circle, stats
             _P, _I,  # out, n_px
             _I, _I, _I, _I, _I, _I, _I,  # width, height, px_start, tiles_x, tiles_y, tile_h, pxb
             _I, _I, _I, _I,  # rpp, sw, n_wedges, the tables' wedge count
             _F, _F, _F, _U, _U,  # zoom, off_x, off_y, frame, seed
             _I, _I, _I, _I, _F,  # use_aa, save, exact, n_traces, min_hit
             _P],  # stream
            _I,
        ),
        "rtdc_trace_info": ([_I, _P], _I),  # instantiation, int[6] out
        "rtdc_error_string": ([_I], ctypes.c_char_p),
    },
    "conv3x3": {
        "rtdc_conv3x3": (
            [_P, _P, _P,  # group inputs (unused groups: None)
             _P, _P, _P,  # group kernels
             _I, _I, _I,  # channels per group
             _I, _I, _I, _I,  # nearest-2x upsample per group, number of groups
             _P, _P,  # bias, out
             _I, _I, _I, _I, _I,  # h_in, w_in, h_out, w_out, cout
             _I, _I, _I, _I,  # stride, pad_top, pad_left, relu
             _P],  # stream
            _I,
        ),
        "rtdc_conv3x3_info": ([_I, _P], _I),  # instantiation, int[8] out
        "rtdc_error_string": ([_I], ctypes.c_char_p),
    },
    "bilateral": {
        "rtdc_bilateral5x5": (
            [_P, _P,  # image, out
             _I, _I, _I, _I,  # n, h, w, c
             _L, _L, _L, _L,  # the image's strides (elements): batch, row, pixel, channel
             _I, _P, _F, _I,  # float4 staging, 25 spatial constants (host), inv_sc, bf16
             _P],  # stream
            _I,
        ),
        "rtdc_error_string": ([_I], ctypes.c_char_p),
    },
    "blur": {
        "rtdc_variable_blur": (
            [_P, _P, _P,  # image, sigma map, out
             _I, _I, _I, _I, _I, _I,  # h_in, w, c, radius, top, h_out
             _L, _L, _L, _L, _L,  # strides (elements): image row, pixel, channel; sigma row, pixel
             _P],  # stream
            _I,
        ),
        "rtdc_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# Seconds and compiler output of the builds this process ran, per source.
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def nvcc_flags(name: str) -> list[str]:
    return [*COMMON_FLAGS, *SOURCE_FLAGS[name]]


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: list[str] | None = None) -> dict[str, pathlib.Path]:
    """Compile every named source (default: all of csrc/*.cu) that has no
    up-to-date library, one nvcc process per source, run in parallel."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, time.perf_counter(),
        )
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        output, _ = proc.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "output": output}
        paths[n].with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{output}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{lib.rtdc_error_string(err).decode()} (cudaError {err})"
