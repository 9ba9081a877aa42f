"""Port trace vs the JAX package.

* The plain version (ops/intersect.py, driven by trace_cuda.trace_sums_plain)
  against the JAX brute-force oracle ``_trace_sums_jax_flat``, with the JAX
  package's ``assert_parity`` bars (fewer than 3e-5 of image values off by
  more than 1e-3, mean difference below 1e-4): the two evaluate the same
  float32 expressions, and differ only in how pow rounds and in the order
  of the per-pixel sums.
* The candidate-list path against the Pallas kernel in interpret mode with
  hoisted tables and a certified gather_len — the JAX production path of
  the main-path scene class — with the same bars.
* Lists and the full sweep give the same sums bit for bit (the lists are
  conservative and walked in ascending id order).
"""

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_tpu.models import renderer as jr
from raytracingdiffusioncurves_tpu.ops import trace_pallas as tp
from raytracingdiffusioncurves_torch.models import renderer as tr
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml

from conftest import make_scene_xml, simple_curve


def assert_parity(j, p, frac=3e-5):
    """tests/test_pallas.py::assert_parity, on (image, blur_map) pairs."""
    img_j, bm_j = j
    img_p, bm_p = p
    d = np.abs(img_j - img_p)
    assert not np.isnan(img_p).any()
    assert (d > 1e-3).mean() < frac, f"diff frac {(d > 1e-3).mean()}"
    assert d.mean() < 1e-4
    db = np.abs(bm_j - bm_p)
    assert (db > 1e-3).mean() < frac


def _weights_xml():
    return make_scene_xml(
        [
            simple_curve(
                [(0, 20), (20, 22), (40, 18), (60, 20)],
                left=[(0, "200,10,50"), (5, "0,255,0"), (10, "10,10,200")],
                blur=[(0, 1.0), (10, 3.0)],
                weight=[(0, 0.5), (10, 2.0)],
                weight_degree=[(0, 0.3), (10, 1.1)],
                use_endcap=True,
            ),
            simple_curve([(40, 50), (30, 40), (20, 44), (8, 30)],
                         weight=[(0, 0.0), (10, 0.0)]),
        ]
    )


def _portal_xml():
    curves = [
        simple_curve([(10 + i, 5), (12 + i, 25), (14 + i, 45), (16 + i, 60)],
                     left=[(0, "255,40,0"), (10, "0,40,255")])
        for i in range(0, 12, 3)
    ]
    curves.append(simple_curve([(30, 10), (32, 20), (34, 30), (36, 40)], connects=5,
                               left=[(0, "128,255,0"), (10, "128,255,0")]))
    curves.append(simple_curve([(50, 10), (52, 20), (54, 30), (56, 40)], connects=4))
    return make_scene_xml(curves)


SCENES = {
    "seeded": (lambda: seeded_scene_xml(0, 64, 64), 16, 16),
    "weights": (_weights_xml, 8, 16),
    "portals": (_portal_xml, 16, 8),
}


def _render_both(name, exact):
    make, k, rpp = SCENES[name]
    xml = make()
    dj = rj.build_device_scene(rj.load_scene_from_string(xml), flatten_subdivisions=k)
    dt = rt.build_device_scene(
        rt.load_scene_from_string(xml), flatten_subdivisions=k, device="cpu"
    )
    kw = dict(rays_per_pixel=rpp, rays_per_block=2048, use_blur=False,
              use_denoiser=False, exact_silhouettes=exact)
    cj, wj, bj = jr._trace_sums_jax_flat(
        dj, rj.Camera(), rj.RenderConfig(**kw), 0, 0, dj.height * dj.width
    )
    cfg = rt.RenderConfig(**kw)
    ct, wt, bt = tc.trace_sums_plain(dt, rt.Camera(), cfg, 0, 0, dt.height * dt.width)
    h, w = dt.height, dt.width
    img_j, bm_j = jr.normalize_sums(cj.reshape(h, w, 3), wj.reshape(h, w), bj.reshape(h, w),
                                    rj.RenderConfig(**kw))
    img_t, bm_t = tr.normalize_sums(ct.reshape(h, w, 3), wt.reshape(h, w), bt.reshape(h, w),
                                    cfg)
    return dt, (np.asarray(img_j), np.asarray(bm_j)), (img_t.numpy(), bm_t.numpy())


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_matches_jax_oracle(name, exact):
    dt, j, t = _render_both(name, exact)
    assert_parity(j, t)
    # the scene is not blank: most pixels see some curve
    assert (t[0][..., :3].sum(-1) > 0).mean() > 0.5
    if name == "portals":
        assert dt.has_portals


def test_candidate_lists_match_pallas_interpret():
    size, rpp = 64, 16
    xml = seeded_scene_xml(0, size, size)
    dj = rj.build_device_scene(rj.load_scene_from_string(xml))
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    kw = dict(rays_per_pixel=rpp, rays_per_block=2048, use_blur=False, use_denoiser=False)
    cfgj, cfgt = rj.RenderConfig(**kw), rt.RenderConfig(**kw)
    cam = (0.9, 1.5, -2.0)
    tj = tp.build_cand_tables(dj, rj.Camera(*cam), cfgj)
    glj = tp.seg_max_count(dj, tj)
    tj = tp.narrow_cand_tables(tj, glj)
    img_p, bm_p = rj.trace_image(dj, rj.Camera(*cam), cfgj, backend="pallas",
                                 cand_tables=tj, gather_len=glj)
    tt = tc.build_cand_tables(dt, rt.Camera(*cam), cfgt)
    glt = tc.seg_max_count(dt, tt)
    assert glt == glj
    img_t, bm_t = tr.trace_image(dt, rt.Camera(*cam), cfgt, cand_tables=tt, gather_len=glt)
    assert_parity((np.asarray(img_p), np.asarray(bm_p)), (img_t.numpy(), bm_t.numpy()))


@pytest.mark.parametrize("exact", [True, False])
def test_lists_equal_full_sweep_bitwise(exact):
    xml = seeded_scene_xml(3, 64, 64)
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=16, rays_per_block=2048, use_denoiser=False,
                          exact_silhouettes=exact)
    n_px = 32 * 64  # a band: rows 16..47
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg, px_start=16 * 64, n_px=n_px)
    lists = tc.trace_sums_flat(dt, rt.Camera(), cfg, 2, 16 * 64, n_px, tabs)
    full = tc.trace_sums_flat(dt, rt.Camera(), cfg, 2, 16 * 64, n_px, None)
    for a, b in zip(lists, full):
        assert torch.equal(a, b)
    assert float(lists[1].sum()) > 0.0
