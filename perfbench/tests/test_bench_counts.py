"""The roofline counts: exact repeats and hand-worked values."""

import torch

from perfbench import core, roofline
from perfbench.reference import device as dv
from perfbench.reference import frame as ref
from perfbench.reference.config import RenderConfig


def _scene_of(segments):
    """A DeviceScene-like holder of seg_consts for chords (x0, y0, x1, y1)."""
    consts = torch.zeros((len(segments), dv.CONST_COLS), dtype=torch.float32)
    for i, (x0, y0, x1, y1) in enumerate(segments):
        consts[i, dv.CONST_EX], consts[i, dv.CONST_EY] = x1 - x0, y1 - y0
        consts[i, dv.CONST_P0X], consts[i, dv.CONST_P0Y] = x0, y0
        consts[i, dv.CONST_VALID] = 1.0
    return type("S", (), {"seg_consts": consts})()


def test_crossings_by_hand():
    # a ray up the y axis from (0, -5): the chord on the x axis (circle of
    # radius 1 at the origin) is entered at t = 4, before the hit at 5; the
    # chord at y = 10 is entered at t = 14, past the hit; the chord at
    # x = 10 lies off the ray; the padding row is never counted
    scene = _scene_of([(-1, 0, 1, 0), (-1, 10, 1, 10), (9, 0, 11, 0)])
    scene.seg_consts = torch.cat([scene.seg_consts, torch.zeros((1, dv.CONST_COLS))])
    o = torch.tensor([[0.0, -5.0]])
    d = torch.tensor([[0.0, 1.0]])
    assert roofline.crossings(scene, o, d, torch.tensor([5.0])).tolist() == [1]
    assert roofline.crossings(scene, o, d, torch.tensor([float("inf")])).tolist() == [2]
    # a ray that starts inside a circle enters it at t < 0 and counts
    assert roofline.crossings(scene, torch.tensor([[0.5, 0.0]]), d,
                              torch.tensor([1.0])).tolist() == [1]


def test_conv_bound_by_hand():
    # enc0a at 1088 x 1920: 11 -> 24 channels, bytes-bound:
    # (11 + 24) * 2 B * 2,088,960 px + 2 * (9 * 11 * 24 + 24) B
    layers = roofline.unet_layers(1088, 1920)
    name, groups, cout, ho, wo = layers[0]
    assert (name, groups, cout, ho, wo) == ("enc0a", [(11, 1088, 1920)], 24, 1088, 1920)
    nbytes = 35 * 2 * 1088 * 1920 + 2 * (9 * 11 * 24 + 24)
    assert nbytes / roofline.HBM_BYTES > 2 * 9 * 11 * 24 * 1088 * 1920 / roofline.BF16_FLOPS
    # the nine layers: 2.292e11 FLOP, 0.397 ms, as the conv kernel's bound
    # has been stated since it was written
    flop = sum(2 * 9 * sum(g[0] for g in gs) * co * h * w for _, gs, co, h, w in layers)
    assert abs(flop - 2.292e11) / 2.292e11 < 1e-3
    assert abs(roofline.conv_bound_s(1088, 1920) - 0.397e-3) < 0.001e-3


def test_counts_repeat_exactly():
    config = {"scene": {"kind": "lady_bug", "seed": 0}, "width": 96, "height": 64,
              "rays_per_pixel": 4, "render": {}}
    xml = core.scene_xml(config, 7)
    settings = core.render_settings(config, 7)
    cam = {"zoom": 1.0, "offset_x": 0.0, "offset_y": 0.0}
    a = roofline.frame_counts(config, xml, settings, cam, "cpu")
    b = roofline.frame_counts(config, xml, settings, cam, "cpu")
    assert a == b
    assert a["trace_flop"] > 0 and a["frame_bound_s"] == (
        a["trace_bound_s"] + a["conv_bound_s"] + a["post_bound_s"])


def test_trace_ops_formula():
    # every 64th row of a 96 x 64 frame is row 32 alone: ops are the
    # per-ray terms of that row scaled by 64 rows
    cfg = RenderConfig(rays_per_pixel=2, seed=3)
    config = {"scene": {"kind": "seeded", "seed": 0}, "width": 96, "height": 64}
    scene = ref.load_scene(core.scene_xml(config, 3), cfg, "cpu")
    from perfbench.reference import intersect
    from perfbench.reference.config import Camera
    ops, rays = roofline.trace_ops(scene, Camera(), cfg, "cpu")
    assert rays == 96 * 2
    pix = torch.arange(32 * 96, 33 * 96).repeat_interleave(2)
    o, d = intersect.make_rays(pix, torch.arange(2).repeat(96), 96, 64, Camera(), cfg, 0)
    _, t, _, hit = intersect.closest_hit(scene, o, d, cfg.min_hit_distance)
    n = roofline.crossings(scene, o, d, torch.where(hit, t, float("inf"))).sum()
    want = 64 * (roofline.RAYGEN_FLOP * 192 + roofline.SHADE_FLOP * int(hit.sum())
                 + roofline.PAIR_FLOP * int(n))
    assert ops == want
