"""Checkpoints: the shipped denoiser weights and session files.

The weights (``weights/*.msgpack``) were written by flax's
``serialization.msgpack_serialize``: a MessagePack map of maps whose leaves
are extension type 1, an ndarray packed as the MessagePack array ``(shape,
dtype name, bytes)``.  This module reads the forms such files hold itself
(short maps, arrays and strings, unsigned ints, ``bin`` and the ndarray
extension) and raises on any other tag, so the port needs neither ``flax``
nor a ``msgpack`` package.  ``save_params`` writes the same forms and no
other: its bytes are those of ``flax.serialization.to_bytes`` of the same
tree, so either package loads a checkpoint the other trained.

A session (``save_session`` / ``load_session``) is the JAX package's
``.npz`` layout, so either package resumes the other's: ``version`` 1, the
temporal state (``prev_image``, ``flow``, ``frame``) and the camera as
float64; the optional ``denoiser`` entry the JAX package writes (flax
MessagePack bytes) is read with the reader above.  The reference
keeps no state beyond screenshots (SURVEY.md section 5); the RNG is
stateless, so resuming at frame N reproduces frame N bit for bit.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..config import Camera
from ..models.renderer import FrameState

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.number("B")
        if tag <= 0x7F:
            return tag
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.string(tag & 0x1F)
        if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.number("BHI"[tag - 0xC4])))
        if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.number("BHI"[tag - 0xC7])
            return self.ext(self.number("b"), n)
        if 0xCC <= tag <= 0xCF:  # uint 8/16/32/64
            return self.number("BHIQ"[tag - 0xCC])
        raise ValueError(f"unsupported MessagePack tag 0x{tag:02x} at byte {self.pos - 1}")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported MessagePack extension type {code}")
        shape, dtype_name, buffer = _Reader(payload).value()
        return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def load_params(path: str):
    """Load trained denoiser weights: nested dicts of numpy arrays, as the
    JAX package's ``load_params`` returns them (layer name -> ``kernel``
    (3, 3, Cin, Cout) and ``bias`` (Cout,), float32).  Pair the result with
    ``models.denoiser.net_for_params`` to get the matching module."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return parse_params(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def parse_params(data: bytes):
    """The tree of a checkpoint's MessagePack bytes (load_params' format)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the MessagePack value")
    return tree


def _pack_uint(n: int) -> bytes:
    if n <= 0x7F:
        return struct.pack(">B", n)
    for tag, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF), (0xCE, "I", 0xFFFFFFFF),
                          (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)):
        if n <= top:
            return struct.pack(">B" + fmt, tag, n)
    raise ValueError(f"integer {n} does not fit a MessagePack uint")


def _pack_str(v: str) -> bytes:
    b = v.encode("utf-8")
    if len(b) > 31:
        raise ValueError(f"key {v!r}: strings above 31 bytes are not a checkpoint form")
    return struct.pack(">B", 0xA0 | len(b)) + b


def _pack_sized(tags: tuple[int, int, int], n: int) -> bytes:
    """The header of a bin or ext of n bytes: its 8-, 16- or 32-bit form."""
    for tag, fmt, top in zip(tags, "BHI", (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if n <= top:
            return struct.pack(">B" + fmt, tag, n)
    raise ValueError(f"{n} bytes do not fit a MessagePack bin or ext")


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.ndim > 15:
        raise ValueError(f"array of {arr.ndim} dimensions is not a checkpoint form")
    raw = arr.tobytes("C")
    payload = (struct.pack(">B", 0x90 | 3)
               + struct.pack(">B", 0x90 | arr.ndim) + b"".join(_pack_uint(d) for d in arr.shape)
               + _pack_str(arr.dtype.name)
               + _pack_sized((0xC4, 0xC5, 0xC6), len(raw)) + raw)
    if len(payload) in (1, 2, 4, 8, 16):  # MessagePack's fixext sizes
        raise ValueError(f"array {arr.shape}: a {len(payload)}-byte payload is not a checkpoint form")
    return _pack_sized((0xC7, 0xC8, 0xC9), len(payload)) + struct.pack(">b", _EXT_NDARRAY) + payload


def _pack(tree) -> bytes:
    if isinstance(tree, dict):
        if len(tree) > 15:
            raise ValueError(f"a map of {len(tree)} entries is not a checkpoint form")
        return struct.pack(">B", 0x80 | len(tree)) + b"".join(
            _pack_str(str(k)) + _pack(v) for k, v in tree.items())
    if isinstance(tree, np.ndarray):
        return _pack_ndarray(tree)
    raise TypeError(f"checkpoint leaves are numpy arrays, got {type(tree).__name__}")


def params_to_bytes(tree) -> bytes:
    """A checkpoint's MessagePack bytes for a tree of dicts with numpy array
    leaves (``params_to_jax``'s tree), in the tree's own key order: the bytes
    ``flax.serialization.to_bytes`` gives the same tree.  Raises on a form
    ``load_params`` does not read."""
    return _pack(tree)


def save_params(path: str, tree) -> str:
    """Write ``tree`` as a checkpoint (``params_to_bytes``), beside ``path``
    and then moved over it."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(params_to_bytes(tree))
    os.replace(tmp, path)
    return path


_FORMAT_VERSION = 1


def save_session(path: str, state: FrameState, camera: Camera) -> str:
    """Write a session: ``state``'s temporal history and frame counter and
    the camera.  The file is written beside ``path`` and moved over it."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "prev_image": state.prev_image.detach().cpu().numpy(),
        "flow": state.flow.detach().cpu().numpy(),
        "frame": np.asarray(np.int32(state.frame)),
        "camera": np.asarray([camera.zoom_factor, camera.offset_x, camera.offset_y], np.float64),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def load_session(path: str, device=None):
    """Read a session written by either package.  Returns (FrameState on
    ``device`` (None = CUDA), Camera, denoiser params as load_params returns
    them, or None)."""
    from .devices import resolve_device

    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {int(z['version'])}")
        flow_np = np.asarray(z["flow"], np.float32)
        prev = torch.from_numpy(np.asarray(z["prev_image"], np.float32).copy()).to(dev)
        flow = torch.from_numpy(flow_np.copy()).to(dev)
        state = FrameState(
            prev_image=prev,
            flow=flow,
            frame=int(z["frame"]),
            # an all-zero flow is known zero: the frame skips the warp
            zero_flow=flow if not flow_np.any() else None,
        )
        cam = Camera(*[float(v) for v in z["camera"]])
        params = parse_params(z["denoiser"].tobytes()) if "denoiser" in z.files else None
    return state, cam, params
