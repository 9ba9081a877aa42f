"""Tiny cells for the CPU tests: the benchmark's own files, beside a config
of a few thousand pixels."""

from __future__ import annotations

import json
import pathlib
import shutil

from perfbench import core

RENDER = {"use_aa": True, "use_blur": True, "use_denoiser": True, "exact_silhouettes": True}
# 6 frames of 100 ms: at rest, a tick in, a drag of 8 px, one back, a tick
# out, at rest
TINY_ZP = {"kind": "session", "frame_ms": 100.0, "pointer_hz": 10.0, "warmup_cycles": 1,
           "gestures": [["rest", 0.1], ["zoom", 1, 10.0], ["pan", 0.1, 80.0, 8, -5],
                        ["pan", 0.1, 80.0, -8, 5], ["zoom", -1, 10.0], ["rest", 0.1]]}
LIMITS = {"display_max": 0.06, "display_mean": 3e-4, "state_max": 0.06, "state_mean": 3e-4}
# Two ranks of 32 rows, the denoiser off; the halo's rows reach across the
# edge, so a band that straddles it reads them.
TINY_BANDS = {"kind": "still_bands", "camera": {"zoom": 1.0, "offset_x": 0.0, "offset_y": 0.0},
              "ranks": 2, "warmup_frames": 3}


def tiny_root(tmp: pathlib.Path) -> pathlib.Path:
    """A benchmark folder: a copy of perfbench's configs, traffic, workloads
    metrics and loops, plus tiny cells ``tiny_still`` (the seeded class),
    ``tiny_zoompan`` (the lady_bug class) and ``tiny_bands`` (the seeded
    class, the denoiser off, two ranks) at 96 x 64."""
    root = tmp / "bench"
    for sub in ("configs", "traffic", "workloads", "metrics", "loops"):
        shutil.copytree(core.BENCH / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, kind in (("tiny_arch", "seeded"), ("tiny_dense", "lady_bug")):
        (root / "configs" / f"{name}.json").write_text(json.dumps(dict(
            source="test", reduced=[], scene={"kind": kind, "seed": 0}, width=96, height=64,
            rays_per_pixel=4, render=RENDER, denoiser="denoiser_r3d.npz")))
    (root / "configs" / "tiny_plain.json").write_text(json.dumps(dict(
        source="test", reduced=[], scene={"kind": "seeded", "seed": 0}, width=96, height=64,
        rays_per_pixel=4, render=dict(RENDER, use_denoiser=False))))
    (root / "traffic" / "tiny_zp.json").write_text(json.dumps(TINY_ZP))
    (root / "traffic" / "tiny_bands.json").write_text(json.dumps(TINY_BANDS))
    check = {"start": True, "band_rows": 4, "limits": LIMITS}
    (root / "workloads" / "tiny_still.json").write_text(json.dumps(dict(
        config="tiny_arch", traffic="still", chips=1, trace_frames=3,
        check=dict(check, frames={"any": 2}))))
    (root / "workloads" / "tiny_zoompan.json").write_text(json.dumps(dict(
        config="tiny_dense", traffic="tiny_zp", chips=1, trace_frames=6,
        check=dict(check, frames={"moving": 1, "rest_build": 1}))))
    # the limits of the cell across cards
    limits = core.read_json(core.BENCH, "workloads", "arch4k_still_4chip")["check"]["limits"]
    (root / "workloads" / "tiny_bands.json").write_text(json.dumps(dict(
        config="tiny_plain", traffic="tiny_bands", chips=2, trace_frames=3,
        check=dict(check, frames={"any": 2}, limits=limits))))
    return root
