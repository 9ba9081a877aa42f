"""The endcapped arch scene (BASELINE config 2's shapes: arch.xml with
endcaps and per-curve weights): the generator against the seeded scene it
extends and against the benchmark's frozen copy, the tables it takes, the
program's counts of it, and the denoiser-off frame on distance-ordered
tables against the benchmark's plain reference."""

import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
from perfbench import scenes as bench_scenes
from perfbench import scenes_endcaps
from perfbench.reference import frame as ref
from perfbench.reference.config import Camera, RenderConfig
from perfbench.reference.plain_frame import blurred_band
from raytracingdiffusioncurves_torch.ops import trace_cuda
from raytracingdiffusioncurves_torch.scene import device as scene_device
from raytracingdiffusioncurves_torch.utils.scenes import endcapped_scene_xml, seeded_scene_xml

SIZES = [(0, 1024, 1024), (3, 1920, 1080), (7, 128, 96)]


def _curves(xml: str) -> list[ET.Element]:
    return list(ET.fromstring(xml))


def _part(curve: ET.Element, tag: str) -> list[dict]:
    node = curve.find(tag)
    return None if node is None else [dict(n.attrib) for n in node]


@pytest.mark.parametrize("seed, width, height", SIZES)
def test_geometry_colours_and_blur_are_the_seeded_scenes(seed, width, height):
    plain, capped = _curves(seeded_scene_xml(seed, width, height)), \
        _curves(endcapped_scene_xml(seed, width, height))
    assert len(capped) == len(plain) == 4
    for a, b in zip(plain, capped):
        for tag in ("control_points_set", "left_colors_set", "right_colors_set",
                    "blur_points_set"):
            assert _part(a, tag) == _part(b, tag), tag
        assert a.get("use_endcap") == "false" and b.get("use_endcap") == "true"


@pytest.mark.parametrize("seed, width, height", SIZES)
def test_every_curve_has_two_knot_weight_tables_in_the_fixtures_ranges(seed, width, height):
    for curve in _curves(endcapped_scene_xml(seed, width, height)):
        for tag, lo, hi in (("weight_set", 0.5, 2.0), ("weight_degree_set", 0.3, 1.1)):
            knots = _part(curve, tag)
            assert [k["globalID"] for k in knots] == ["0", "20"]
            assert all(lo <= float(k["w"]) <= hi for k in knots)


def test_weights_come_from_a_stream_of_their_own():
    # one seed, two sizes: the same weights; two seeds: others
    def weights(seed, w, h):
        return [_part(c, "weight_set") + _part(c, "weight_degree_set")
                for c in _curves(endcapped_scene_xml(seed, w, h))]

    assert weights(0, 1024, 1024) == weights(0, 96, 64) != weights(1, 1024, 1024)


@pytest.mark.parametrize("seed, colour_seed", [(0, 2**31 + 5), (0, 0), (4, 11)])
def test_the_benchmarks_copy_keeps_geometry_blur_and_weights(seed, colour_seed):
    program = _curves(endcapped_scene_xml(seed, 1024, 1024))
    bench = _curves(scenes_endcaps.endcapped_scene_xml(seed, 1024, 1024, colour_seed))
    # the colours are the benchmark's seeded scene's, from the colour seed
    seeded = _curves(bench_scenes.seeded_scene_xml(seed, 1024, 1024, colour_seed))
    for a, b, c in zip(program, bench, seeded):
        for tag in ("control_points_set", "blur_points_set", "weight_set",
                    "weight_degree_set"):
            assert _part(a, tag) == _part(b, tag), tag
        for tag in ("left_colors_set", "right_colors_set"):
            assert _part(b, tag) == _part(c, tag), tag
        assert a.attrib == b.attrib


def test_config_2_takes_uncapped_distance_ordered_lists():
    # 1024^2 x 128 rpp: 256 sub-segments, half of them the 8 endcap loops;
    # past slot mode (128), so distance-ordered lists of all 256 slots over
    # 32 wedges, no chunk lists and no horizon fallback
    scene = rt.load_scene_from_string(endcapped_scene_xml(0, 1024, 1024))
    dev = rt.build_device_scene(scene, device="cpu")
    assert (dev.n_sub, dev.s_pad) == (256, 256) and dev.uniform_wd is None
    assert scene_device.endcap_segments(scene).sum() == 8
    assert scene_device.weighted_curves(scene) == 4
    cfg = rt.RenderConfig(rays_per_pixel=128, use_denoiser=False)
    assert trace_cuda.table_layout(dev, cfg) == ("seg", 0)
    tables = rt.build_cand_tables(dev, rt.Camera(), cfg)
    assert tables.dist_ordered and tables.chunk_ids is None
    assert tuple(tables.ids.shape) == (1024, 32, 256)
    assert rt.seg_max_count(dev, tables) is None


def test_the_seeded_scene_has_no_endcaps_or_weights():
    scene = rt.load_scene_from_string(seeded_scene_xml(0, 1024, 1024))
    assert not scene_device.endcap_segments(scene).any()
    assert scene_device.weighted_curves(scene) == 0


@pytest.mark.parametrize("seed", [0, 2**31 + 9])
def test_denoiser_off_frame_equals_the_plain_reference(seed):
    # 128 x 96 at 16 rpp: 256 sub-segments, distance-ordered lists over 4
    # wedges.  Tolerance 0: the reference is a frozen copy of the plain
    # path, and conservative tables give the full sweep's sums bit for bit,
    # so the frame on tables and the reference's full sweep agree exactly.
    xml = scenes_endcaps.endcapped_scene_xml(0, 128, 96, seed % (1 << 63))
    settings = dict(rays_per_pixel=16, use_denoiser=False, seed=seed)
    dscene = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    cfg = rt.RenderConfig(**settings)
    tables = rt.build_cand_tables(dscene, rt.Camera(), cfg)
    assert tables.dist_ordered and tables.ids.shape[-1] == 256
    state = rt.init_frame_state(128, 96, device="cpu")
    for _ in range(2):  # frames 0 and 1
        st = state
        image, state = rt.render_frame(dscene, rt.Camera(), st, cfg, cand_tables=tables)
    scene = ref.load_scene(xml, RenderConfig(**settings), "cpu")
    for r0, r1 in ((0, 8), (44, 52), (88, 96), (0, 96)):
        shown, nxt = blurred_band(scene, Camera(), RenderConfig(**settings), st.frame, r0, r1)
        assert torch.equal(shown, image[r0:r1]) and torch.equal(nxt, state.prev_image[r0:r1])
    # the weights and endcaps reach the image: not the seeded scene's frame
    plain = rt.build_device_scene(rt.load_scene_from_string(
        bench_scenes.seeded_scene_xml(0, 128, 96, seed % (1 << 63))), device="cpu")
    other, _ = rt.render_frame(plain, rt.Camera(), st, cfg)
    assert not np.allclose(other.numpy(), image.numpy(), atol=1e-3)


def test_cli_renders_the_scene_without_the_denoiser(tmp_path):
    from raytracingdiffusioncurves_torch.cli import main

    scene = tmp_path / "arch.xml"
    scene.write_text(endcapped_scene_xml(0, 48, 32))
    out = tmp_path / "o.png"
    assert main([str(scene), "4", "--no-denoiser", "--device", "cpu", "--frames", "2",
                 "--out", str(out)]) == 0
    assert out.stat().st_size > 0
