"""The dense portal scene (the lady_bug class with one portal pair): the
generator against the drawing it extends and against the benchmark's
frozen copy, the tables it takes, the program's counts of it, and the
port's plain trace on distance-ordered tables against the benchmark's
plain reference, whose trace follows the portals."""

import re
import xml.etree.ElementTree as ET

import pytest
import torch

import raytracingdiffusioncurves_torch as rt
from perfbench import scenes as bench_scenes
from perfbench import scenes_portals
from perfbench.reference import frame as ref
from perfbench.reference.config import Camera, RenderConfig
from raytracingdiffusioncurves_torch.ops import trace_cuda
from raytracingdiffusioncurves_torch.utils import timing
from raytracingdiffusioncurves_torch.utils.scenes import dense_scene_xml, portal_dense_scene_xml


def _curves(xml: str) -> list[ET.Element]:
    return list(ET.fromstring(xml))


@pytest.mark.parametrize("seed, width, height", [(0, 1920, 1080), (2, 320, 192)])
def test_two_portals_each_connecting_to_the_other(seed, width, height):
    doc = ET.fromstring(portal_dense_scene_xml(seed, width, height))
    curves = list(doc)
    assert doc.get("nb_curves") == str(len(curves)) == "40"
    n = len(curves) - 2
    assert [c.get("connects") for c in curves[:n]] == [None] * n
    assert (curves[n].get("connects"), curves[n + 1].get("connects")) == (str(n + 1), str(n))
    for c in curves[n:]:
        pts = [(float(p.get("x")), float(p.get("y"))) for p in c.find("control_points_set")]
        # one straight cubic, stored (row, column): a column of the canvas
        assert len(pts) == 4 and len({y for _, y in pts}) == 1
        assert c.find("weight_set") is None and c.get("use_endcap") == "false"
        blur = [float(b.get("value")) for b in c.find("blur_points_set")]
        assert all(0.5 <= b <= 2.0 for b in blur)
    # the drawing is dense_scene_xml's exactly
    plain = _curves(dense_scene_xml(seed, width, height, "lady_bug"))
    assert [ET.tostring(c) for c in curves[:n]] == [ET.tostring(c) for c in plain]


@pytest.mark.parametrize("seed, colour_seed", [(0, 2**31 + 5), (0, 0), (4, 2**62 + 11)])
def test_the_benchmarks_copy_gives_the_same_xml(seed, colour_seed):
    for w, h in ((1920, 1080), (96, 64)):
        assert portal_dense_scene_xml(seed, w, h, colour_seed) == \
            scenes_portals.portal_dense_scene_xml(seed, w, h, colour_seed)
        # the drawing with its colours split off is the frozen dense copy's
        assert dense_scene_xml(seed, w, h, "lady_bug", colour_seed) == \
            bench_scenes.dense_scene_xml(seed, w, h, "lady_bug", colour_seed)


def test_colours_come_from_the_colour_seed_alone():
    a, b = (_curves(portal_dense_scene_xml(0, 320, 192, c)) for c in (1, 2))
    for x, y in zip(a, b):
        for tag in ("control_points_set", "blur_points_set"):
            assert ET.tostring(x.find(tag)) == ET.tostring(y.find(tag)), tag
    assert ET.tostring(a[-1].find("left_colors_set")) != ET.tostring(b[-1].find("left_colors_set"))


def test_the_scene_takes_the_lady_bug_classs_tables():
    # 96 cubics: 1536 sub-segments, s_pad 1536 as the drawing alone (1504):
    # capped distance-ordered lists of 256 slots with the chunk fallback
    dev = rt.build_device_scene(rt.load_scene_from_string(portal_dense_scene_xml(0)),
                                device="cpu")
    plain = rt.build_device_scene(rt.load_scene_from_string(
        dense_scene_xml(0, 1920, 1080, "lady_bug")), device="cpu")
    assert (dev.n_sub, dev.s_pad, plain.n_sub, plain.s_pad) == (1536, 1536, 1504, 1536)
    assert dev.has_portals and not plain.has_portals
    cfg = rt.RenderConfig(rays_per_pixel=256, use_denoiser=False)
    assert trace_cuda.table_layout(dev, cfg) == trace_cuda.table_layout(plain, cfg) == ("seg", 0)
    assert trace_cuda.n_traces(dev, cfg) == 3 and trace_cuda.n_traces(plain, cfg) == 1


@pytest.mark.parametrize("make, n_traces", [(portal_dense_scene_xml, 3),
                                             (lambda s, w, h, c: dense_scene_xml(s, w, h), 1)])
def test_the_launch_span_carries_the_trace_count(make, n_traces):
    xml = make(0, 64, 48, 3)
    dev = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=4, use_denoiser=False)
    timing.drain()
    timing.enable()
    try:
        rt.render_frame(dev, rt.Camera(), rt.init_frame_state(64, 48, device="cpu"), cfg)
    finally:
        timing.disable()
    spans = {s.name: s.attrs for s in timing.drain()}
    assert spans["trace.launch"]["n_traces"] == n_traces


@pytest.mark.parametrize("seed", [0, 2**31 + 9])
def test_plain_trace_on_tables_equals_the_references_portal_trace(seed):
    # 64 x 48 at 8 rpp: capped distance-ordered lists (256 of 1536 slots)
    # with the chunk fallback.  Tolerance 0: the reference is a frozen copy
    # of the plain path, and conservative tables give the full sweep's sums
    # bit for bit, continuation rays included.
    w, h = 64, 48
    xml = scenes_portals.portal_dense_scene_xml(0, w, h, seed % (1 << 63))
    settings = dict(rays_per_pixel=8, use_denoiser=False, seed=seed)
    dscene = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    cfg = rt.RenderConfig(**settings)
    tables = rt.build_cand_tables(dscene, rt.Camera(), cfg)
    assert tables.dist_ordered and tables.ids.shape[-1] == 256 and tables.chunk_ids is not None
    csum, wsum, bsum = trace_cuda.trace_sums_plain(dscene, rt.Camera(), cfg, 1, 0, w * h, tables)
    scene = ref.load_scene(xml, RenderConfig(**settings), "cpu")
    rc, rw, rb = ref.trace_rows(scene, Camera(), RenderConfig(**settings), 1, 0, h)
    assert torch.equal(csum, rc.reshape(-1, 3)) and torch.equal(wsum, rw.reshape(-1))
    assert torch.equal(bsum, rb.reshape(-1))
    # the bounces reach the sums: not the scene without its connects
    flat = rt.build_device_scene(rt.load_scene_from_string(
        re.sub(r' connects="\d+"', "", xml)), device="cpu")
    assert not flat.has_portals
    fc, fw, _ = trace_cuda.trace_sums_plain(flat, rt.Camera(), cfg, 1, 0, w * h)
    assert not torch.equal(fw, wsum)
