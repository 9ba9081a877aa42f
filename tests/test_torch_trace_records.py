"""The CUDA trace kernel's packed per-segment records (scene/device.py
``pack_records``) against the scene tables they are packed from: bit for
bit, on the CPU.

The kernel reads nothing of a scene but these records: a pair test reads
the 32-byte walk record (seg_consts columns EX, EY, C1, P0X, P0Y, BAND, QUAD
and the segment's id as int32 bits), a shaded winner its 256-byte shade
record (its column of shade_all_t, read as sixteen 16-byte values).  So the
records must be the tables' float32 values exactly, in the positions the
kernel reads (csrc/trace.cu ``unpack`` and ``shade``).  Checked on the
inline scenes of tests/conftest.py (weights and end caps, portals, an
adaptive flattening), the seeded main-path scene, a dense generated scene of
the lady_bug class, and scenes carried over from the JAX package's build
through ``from_jax_arrays``.
"""

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.scene import device as tdev
from raytracingdiffusioncurves_torch.utils.scenes import dense_scene_xml, seeded_scene_xml

from conftest import make_scene_xml, simple_curve
from test_torch_scene import ARRAYS, META

# What csrc/trace.cu reads where: walk record column -> seg_consts column,
# and the shade_all_t rows that shade() takes from fixed 16-byte slots of a
# shade record (float4 k holds rows 4k .. 4k+3).
KERNEL_WALK_COLS = {0: tdev.CONST_EX, 1: tdev.CONST_EY, 2: tdev.CONST_C1, 3: tdev.CONST_P0X,
                    4: tdev.CONST_P0Y, 5: tdev.CONST_BAND, 6: tdev.CONST_QUAD}
KERNEL_SHADE_ROWS = {
    "COL_CL0": 4, "COL_CL1": 7, "COL_CR0": 10, "COL_CR1": 13, "COL_BLUR0": 16,
    "COL_BLUR1": 17, "COL_WM0": 18, "COL_WM1": 19, "COL_WD0": 20, "COL_WD1": 21,
    "COL_PORTAL": 22, "ALLT_SRC_CTRL": 37, "ALLT_TGT_CTRL": 45, "ALLT_T0": 53, "ALLT_DT": 54,
    "ALLT_BAND": 55,
}


def _weights_xml():
    return make_scene_xml([
        simple_curve(
            [(0, 20), (20, 22), (40, 18), (60, 20)],
            left=[(0, "200,10,50"), (5, "0,255,0"), (10, "10,10,200")],
            blur=[(0, 1.0), (10, 3.0)],
            weight=[(0, 0.5), (10, 2.0)],
            weight_degree=[(0, 0.3), (10, 1.1)],
            use_endcap=True,
        ),
        simple_curve([(5, 50), (25, 30), (35, 60), (58, 44)],
                     right=[(0, "20,200,90"), (10, "250,250,0")]),
    ])


def _portal_xml():
    curves = [simple_curve([(10 + i, 5), (12 + i, 25), (14 + i, 45), (16 + i, 60)])
              for i in range(0, 12, 3)]
    curves.append(simple_curve([(30, 10), (32, 20), (34, 30), (36, 40)], connects=5))
    curves.append(simple_curve([(50, 10), (52, 20), (54, 30), (56, 40)], connects=4))
    return make_scene_xml(curves)


SCENES = {
    "weights_endcaps": (_weights_xml, 16),
    "portals": (_portal_xml, 16),
    "adaptive": (_weights_xml, 2),
    "seeded256": (lambda: seeded_scene_xml(0, 256, 256), 16),
    "lady_bug_dense": (lambda: dense_scene_xml(0, 320, 192, "lady_bug"), 16),
}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.int32)


def assert_records(dt: tdev.DeviceScene):
    s_pad = dt.s_pad
    walk, shade = dt.walk_records, dt.shade_records
    assert walk.shape == (s_pad, tdev.WALK_COLS) and walk.dtype == torch.float32
    assert shade.shape == (s_pad, tdev.ALLT_ROWS) and shade.dtype == torch.float32
    assert walk.is_contiguous() and shade.is_contiguous()
    assert walk.device == shade.device == dt.device
    # rows of 32 and 256 bytes: the kernel's 16-byte copies and loads
    assert walk.stride(0) * 4 == 32 and shade.stride(0) * 4 == 256
    for k, col in KERNEL_WALK_COLS.items():
        assert np.array_equal(_bits(walk[:, k]), _bits(dt.seg_consts[:, col])), k
    assert tuple(KERNEL_WALK_COLS.values()) == tdev.WALK_CONST_COLS
    assert np.array_equal(_bits(walk[:, tdev.WALK_ID]), np.arange(s_pad, dtype=np.int32))
    assert np.array_equal(_bits(shade), _bits(dt.shade_all_t.T))
    for row in KERNEL_SHADE_ROWS.values():
        assert np.array_equal(_bits(shade.reshape(s_pad, 16, 4)[:, row // 4, row % 4]),
                              _bits(dt.shade_all_t[row]))


def test_kernel_positions_match_the_table_layout():
    """The fixed positions csrc/trace.cu reads are the tables' own."""
    for name, row in KERNEL_SHADE_ROWS.items():
        assert getattr(tdev, name) == row, name
    assert tdev.ALLT_ROWS == 64 and tdev.WALK_COLS == 8 and tdev.WALK_ID == 7


@pytest.mark.parametrize("name", sorted(SCENES))
def test_records_equal_the_scene_tables_bitwise(name):
    make, k = SCENES[name]
    dt = rt.build_device_scene(rt.load_scene_from_string(make()), flatten_subdivisions=k,
                               device="cpu")
    if name == "lady_bug_dense":
        assert dt.s_pad > 1024 and dt.n_sub % 64 != 0
    if name == "portals":
        assert dt.has_portals and bool((dt.shade_all_t[tdev.COL_PORTAL] > 0).any())
    assert_records(dt)


@pytest.mark.parametrize("name", ["portals", "weights_endcaps", "lady_bug_dense"])
def test_records_through_from_jax_arrays(name):
    """A scene built by the JAX package, carried over by from_jax_arrays:
    its records are the JAX tables' columns and equal those of the port's
    own build."""
    make, k = SCENES[name]
    xml = make()
    dj = rj.build_device_scene(rj.load_scene_from_string(xml), flatten_subdivisions=k)
    arrays = {f: np.asarray(getattr(dj, f)) for f in ARRAYS}
    ds = tdev.from_jax_arrays(arrays, {f: getattr(dj, f) for f in META}, device="cpu")
    assert_records(ds)
    assert np.array_equal(_bits(ds.walk_records[:, 0]),
                          arrays["seg_consts"][:, tdev.CONST_EX].view(np.int32))
    assert np.array_equal(_bits(ds.shade_records), np.ascontiguousarray(
        arrays["shade_all_t"].T).view(np.int32))
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), flatten_subdivisions=k,
                               device="cpu")
    for f in ("walk_records", "shade_records"):
        assert np.array_equal(_bits(getattr(ds, f)), _bits(getattr(dt, f))), f
