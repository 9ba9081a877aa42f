"""ctypes bindings of the native C++ scene loader (``scene/native/loader.cpp``,
a verbatim copy of the JAX package's).

The shared library is built at first use with ``g++ -O2 -fPIC -std=c++17
-shared`` into ``build/native/`` at the root of the checkout (never into
the source tree), named by a hash of the source and the flags, so an edited
source rebuilds and concurrent processes never load a half-written file.
``available()`` tells whether it built.  The native and the Python loader
(``scene/xml_loader.py``) implement the same spec, the reference's scene
pipeline (optixHello.cpp:211-515), and give bitwise equal tables
(tests/test_torch_native_loader.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

from .xml_loader import AttrTable, SceneTables

SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "loader.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]


class _RtdcAttr(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.POINTER(ctypes.c_int64)),
        ("u", ctypes.POINTER(ctypes.c_float)),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("n_entries", ctypes.c_int64),
        ("channels", ctypes.c_int32),
    ]


class _RtdcScene(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("n_segments", ctypes.c_int64),
        ("n_curves", ctypes.c_int64),
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("curve_map", ctypes.POINTER(ctypes.c_int32)),
        ("curve_index", ctypes.POINTER(ctypes.c_int32)),
        ("curve_connect", ctypes.POINTER(ctypes.c_int32)),
        ("curve_first_segment", ctypes.POINTER(ctypes.c_int32)),
        ("curve_segment_count", ctypes.POINTER(ctypes.c_int32)),
        ("color_left", _RtdcAttr),
        ("color_right", _RtdcAttr),
        ("blur", _RtdcAttr),
        ("weight", _RtdcAttr),
        ("weight_degree", _RtdcAttr),
        ("error", ctypes.c_char_p),
        ("impl", ctypes.c_void_p),
    ]


# The loaded library, or the reason it could not be built (per process).
_STATE: dict = {}


def lib_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librtdc_loader-{digest}.so"


def build() -> pathlib.Path:
    """Compile the loader unless an up-to-date library exists; raises with
    the compiler's output when it fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib():
    if "lib" in _STATE:
        return _STATE["lib"]
    lib = ctypes.CDLL(str(build()))
    lib.rtdc_load_scene.restype = ctypes.POINTER(_RtdcScene)
    lib.rtdc_load_scene.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
    ]
    lib.rtdc_free_scene.argtypes = [ctypes.POINTER(_RtdcScene)]
    _STATE["lib"] = lib
    return lib


def available() -> bool:
    """Whether the native loader is built (building it on the first call)."""
    if "error" not in _STATE:
        try:
            _load_lib()
            _STATE["error"] = None
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _STATE["error"] = e
    return _STATE["error"] is None


def _attr_from_native(a: _RtdcAttr, n_curves: int) -> AttrTable:
    n = int(a.n_entries)
    ch = int(a.channels)
    index = np.ctypeslib.as_array(a.index, shape=(n_curves * 2,)).reshape(n_curves, 2).copy()
    u = np.ctypeslib.as_array(a.u, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    vals = (
        np.ctypeslib.as_array(a.values, shape=(n * ch,)).reshape(n, ch).copy()
        if n
        else np.zeros((0, ch), np.float32)
    )
    return AttrTable(index=index.astype(np.int64), u=u, values=vals)


def load_scene_native(
    path_or_text: str,
    diffusion_curve_save: bool = True,
    endcap_size: float = 8.0,
    default_weight_degree: float = 0.5,
    is_text: bool = False,
    suppress_endcaps: bool = False,
) -> SceneTables:
    """Parse an Orzan XML (a path, or the document itself with
    ``is_text``) with the native loader; the same tables as
    xml_loader.load_scene.  Raises ValueError on a malformed document."""
    lib = _load_lib()
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    ptr = lib.rtdc_load_scene(
        text.encode(), int(diffusion_curve_save), endcap_size,
        default_weight_degree, int(suppress_endcaps),
    )
    try:
        sc = ptr.contents
        if sc.error:
            raise ValueError(f"native loader: {sc.error.decode()}")
        n_seg, n_cur = int(sc.n_segments), int(sc.n_curves)

        def arr(p, n, dt=np.int32):
            return np.ctypeslib.as_array(p, shape=(n,)).astype(dt, copy=True)

        vertices = (
            np.ctypeslib.as_array(sc.vertices, shape=(n_seg * 8,)).reshape(n_seg, 4, 2).copy()
        )
        return SceneTables(
            width=int(sc.width),
            height=int(sc.height),
            vertices=vertices,
            curve_map=arr(sc.curve_map, n_seg),
            curve_index=arr(sc.curve_index, n_seg),
            curve_connect=arr(sc.curve_connect, n_cur),
            curve_first_segment=arr(sc.curve_first_segment, n_cur),
            curve_segment_count=arr(sc.curve_segment_count, n_cur),
            color_left=_attr_from_native(sc.color_left, n_cur),
            color_right=_attr_from_native(sc.color_right, n_cur),
            blur=_attr_from_native(sc.blur, n_cur),
            weight=_attr_from_native(sc.weight, n_cur),
            weight_degree=_attr_from_native(sc.weight_degree, n_cur),
            diffusion_curve_save=diffusion_curve_save,
        )
    finally:
        lib.rtdc_free_scene(ptr)
