"""What the per-layer readers share: which layer a device operation belongs
to, by its kernel's name, and per-frame sums over the traced window."""

from __future__ import annotations

# Name fragments of the program's hand-written kernels as the profiler
# shows them (demangled): csrc/trace.cu's trace_kernel<...> and
# csrc/conv3x3.cu's conv3x3_kernel / conv3x3_kernel_3blocks.
TRACE_KERNEL = "trace_kernel"
CONV_KERNEL = "conv3x3_kernel"


def layer_of(name: str) -> str:
    """``trace``, ``conv`` or ``torch`` (every other device operation: the
    plain-torch post-processing, copies and fills)."""
    if TRACE_KERNEL in name:
        return "trace"
    if CONV_KERNEL in name:
        return "conv"
    return "torch"


def device_s(tr, layer: str) -> float:
    """Device seconds of one layer's operations in the traced window."""
    return sum(d for n, _, d in tr.device_ops if layer_of(n) == layer) * 1e-9


def per_frame_ms(tr, layer: str):
    """Device ms per traced frame of a layer, or None when none ran."""
    s = device_s(tr, layer)
    if s <= 0.0 or tr.frames <= 0:
        return None
    return s * 1e3 / tr.frames


def frame_s(tr) -> float | None:
    """The traced window's seconds per frame."""
    if tr.frames <= 0 or tr.window_s <= 0.0:
        return None
    return tr.window_s / tr.frames


def idle_share(tr, kind: str):
    """% of the traced window in which no operation ran on the device."""
    if tr.kind != kind or not tr.device_ops or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def enqueue_ms(tr, kind: str):
    """Host ms per frame inside the harness's enqueue spans."""
    if tr.kind != kind:
        return None
    spans = [d for n, _, d in tr.spans if n.split(".")[0] == "enqueue"]
    if not spans:
        return None
    return sum(spans) * 1e-6 / len(spans)


def roofline_share(tr, kind: str, layer: str, bound_s):
    """% of a layer's least time per frame (``bound_s()``, seconds, from
    roofline.py) over its device time per frame."""
    if tr.kind != kind:
        return None
    ms = per_frame_ms(tr, layer)
    if ms is None:
        return None
    return 100.0 * bound_s() * 1e3 / ms


def conv_bound_s(tr) -> float:
    from perfbench import roofline

    return roofline.conv_bound_s(tr.cell.config["height"], tr.cell.config["width"])
