"""The port's native C++ scene loader (its own copy of loader.cpp, built
with g++ into build/native/) vs the port's Python loader: bitwise equal
tables, after tests/test_native_loader.py: synthetic endcaps and portals,
the no-save convention, errors; also the generated scenes of the smoke
script and load_scene's choice of the native loader."""

import hashlib
import pathlib

import numpy as np
import pytest

from raytracingdiffusioncurves_torch.scene import native_loader, xml_loader
from raytracingdiffusioncurves_torch.utils.scenes import (
    dense_scene_xml,
    portal_weights_scene_xml,
    seeded_scene_xml,
)

from conftest import make_scene_xml, simple_curve

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native_loader.available(), "the native loader did not build"


def assert_scene_equal(a, b):
    assert a.width == b.width and a.height == b.height
    assert a.diffusion_curve_save == b.diffusion_curve_save
    for name in ("vertices", "curve_map", "curve_index", "curve_connect",
                 "curve_first_segment", "curve_segment_count"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in ("color_left", "color_right", "blur", "weight", "weight_degree"):
        ta, tb = getattr(a, name), getattr(b, name)
        for f in ("index", "u", "values"):
            x, y = getattr(ta, f), getattr(tb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f"{name}.{f}"


def test_the_source_is_the_ports_own_verbatim_copy():
    ours = native_loader.SOURCE
    assert ours.is_relative_to(ROOT / "raytracingdiffusioncurves_torch")
    theirs = ROOT / "raytracingdiffusioncurves_tpu" / "scene" / "native" / "loader.cpp"
    assert hashlib.sha256(ours.read_bytes()).digest() == hashlib.sha256(
        theirs.read_bytes()).digest()
    assert native_loader.lib_path().parent == ROOT / "build" / "native"
    assert native_loader.lib_path().exists()


def test_native_matches_python_synthetic_endcaps_portals():
    xml = make_scene_xml(
        [
            simple_curve(
                [(0, 20), (20, 22), (40, 18), (60, 20), (70, 25), (75, 30), (80, 40)],
                left=[(0, "200,10,50"), (15, "0,255,0"), (20, "10,10,200")],
                blur=[(0, 1.0), (20, 3.0)],
                weight=[(0, 0.5), (20, 2.0)],
                weight_degree=[(0, 0.3), (20, 1.1)],
                use_endcap=True,
            ),
            simple_curve([(5, 5), (6, 6), (7, 7), (8, 8)], connects=0),
        ]
    )
    py = xml_loader.load_scene_from_string(xml)
    nat = native_loader.load_scene_native(xml, is_text=True)
    assert_scene_equal(py, nat)
    assert nat.curve_connect[1] == 0


def test_native_matches_python_no_save_convention():
    xml = make_scene_xml([simple_curve([(1, 2), (3, 4), (5, 6), (7, 8)])])
    py = xml_loader.load_scene_from_string(xml, diffusion_curve_save=False)
    nat = native_loader.load_scene_native(xml, is_text=True, diffusion_curve_save=False)
    assert_scene_equal(py, nat)


@pytest.mark.parametrize("xml", [
    seeded_scene_xml(0, 1024, 1024),
    dense_scene_xml(0, 1920, 1088, "lady_bug"),
    portal_weights_scene_xml(256, 256),
], ids=["seeded", "lady_bug_class", "portal_weights"])
def test_native_matches_python_on_generated_scenes(xml):
    assert_scene_equal(xml_loader.load_scene_from_string(xml),
                       native_loader.load_scene_native(xml, is_text=True))


@pytest.mark.parametrize("kwargs", [
    {"suppress_endcaps": True},
    {"diffusion_curve_save": False},
    {"endcap_size": 5.0, "default_weight_degree": 0.25},
], ids=["no_endcaps", "no_save", "endcap_size"])
def test_load_scene_native_switch(tmp_path, kwargs):
    """load_scene takes the native loader wherever it builds, and passes
    every option on: the same tables as the Python parser's."""
    path = tmp_path / "s.xml"
    path.write_text(dense_scene_xml(1, 256, 256, "dolphin"))
    assert native_loader.available()
    want = xml_loader.load_scene_from_string(path.read_text(), **kwargs)
    assert_scene_equal(xml_loader.load_scene(str(path), **kwargs), want)


def test_native_reports_errors():
    with pytest.raises(ValueError):
        native_loader.load_scene_native(
            '<curve_set image_width="8" image_height="8"><curve></curve></curve_set>',
            is_text=True,
        )
