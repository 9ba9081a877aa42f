"""Port scene tables vs the JAX package's build: bitwise equal.

The scene tables are the port's "weights": every trace result rests on
them, so they must be the JAX build's float32 values bit for bit (both
build in numpy float64 and round once)."""

import numpy as np
import pytest

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.scene import device as tdev
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml

from conftest import make_scene_xml, simple_curve

ARRAYS = ("seg_consts", "shade_table", "shade_all_t", "chunk_bounds")
META = ("width", "height", "n_sub", "s_pad", "has_portals", "max_blur",
        "uniform_wd", "uniform_wm")


def _endcap_weights_xml():
    return make_scene_xml(
        [
            simple_curve(
                [(0, 20), (20, 22), (40, 18), (60, 20)],
                left=[(0, "200,10,50"), (5, "0,255,0"), (10, "10,10,200")],
                blur=[(0, 1.0), (10, 3.0)],
                weight=[(0, 0.5), (10, 2.0)],
                weight_degree=[(0, 0.3), (10, 1.1)],
                use_endcap=True,
            )
        ]
    )


def _portal_xml():
    curves = [
        simple_curve([(10 + i, 5), (12 + i, 25), (14 + i, 45), (16 + i, 60)])
        for i in range(0, 12, 3)
    ]
    curves.append(simple_curve([(30, 10), (32, 20), (34, 30), (36, 40)], connects=5))
    curves.append(simple_curve([(50, 10), (52, 20), (54, 30), (56, 40)], connects=4))
    return make_scene_xml(curves)


SCENES = {
    "seeded64": (lambda: seeded_scene_xml(0, 64, 64), 16),
    "seeded1024": (lambda: seeded_scene_xml(0, 1024, 1024), 16),
    "endcap_weights": (_endcap_weights_xml, 8),
    "portals": (_portal_xml, 16),
    "adaptive": (_endcap_weights_xml, 2),
}


def _both(name):
    make, k = SCENES[name]
    xml = make()
    dj = rj.build_device_scene(rj.load_scene_from_string(xml), flatten_subdivisions=k)
    dt = rt.build_device_scene(
        rt.load_scene_from_string(xml), flatten_subdivisions=k, device="cpu"
    )
    return dj, dt


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_bitwise_equal(name):
    dj, dt = _both(name)
    for f in ARRAYS:
        a = np.asarray(getattr(dj, f))
        b = getattr(dt, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, f
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), f
    for f in META:
        assert getattr(dj, f) == getattr(dt, f), f


def test_seeded_scene_is_main_path_class():
    """The main-path scene flattens to s_pad <= 128 with uniform weights —
    the slot-mode segment-list class of the reference arch scene."""
    _, dt = _both("seeded1024")
    assert dt.n_sub == dt.s_pad == 128
    assert dt.uniform_wd == 0.5 and dt.uniform_wm == 1.0
    assert dt.max_blur > 0.0 and not dt.has_portals


def test_from_jax_arrays_round_trip():
    dj, dt = _both("portals")
    arrays = {f: np.asarray(getattr(dj, f)) for f in ARRAYS}
    meta = {f: getattr(dj, f) for f in META}
    ds = tdev.from_jax_arrays(arrays, meta, device="cpu")
    for f in ARRAYS:
        assert np.array_equal(getattr(ds, f).numpy().view(np.int32),
                              getattr(dt, f).numpy().view(np.int32)), f
    for f in META:
        assert getattr(ds, f) == getattr(dt, f), f
