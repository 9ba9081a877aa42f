"""Port candidate lists vs the JAX package's ``_segment_ids(order="id")``:
ids and counts equal (tolerance 0), on the seeded main-path scene at
64^2 x 16 rpp, for an identity and a pan/zoom camera."""

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_tpu.ops import candidates as jcand
from raytracingdiffusioncurves_tpu.ops import trace_pallas as tp
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml

SIZE, RPP = 64, 16


@pytest.fixture(scope="module")
def scenes():
    xml = seeded_scene_xml(0, SIZE, SIZE)
    dj = rj.build_device_scene(rj.load_scene_from_string(xml))
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    return dj, dt


@pytest.mark.parametrize("cam", [(1.0, 0.0, 0.0), (0.7, 5.5, -3.25)])
def test_segment_ids_equal_jax(scenes, cam):
    dj, dt = scenes
    cfgj = rj.RenderConfig(rays_per_pixel=RPP, rays_per_block=2048, use_denoiser=False)
    cfgt = rt.RenderConfig(rays_per_pixel=RPP, rays_per_block=2048, use_denoiser=False)
    _, _, sw, n_wedges, tile_h, tiles_x, tiles_y, _ = tp._grid_geom(
        dj, cfgj, SIZE, SIZE * SIZE
    )
    assert tc._grid_geom(dt, cfgt, SIZE, SIZE * SIZE) == tp._grid_geom(
        dj, cfgj, SIZE, SIZE * SIZE
    )
    assert n_wedges > 1 and tc.accel_kind(dt, cfgt) == "seg"
    ids, cnt, _, _ = jcand._segment_ids(
        dj.seg_consts, SIZE, SIZE, *cam, RPP, sw, tiles_x, tiles_y,
        tp.TILE_W, tile_h, 0, True, dj.s_pad, order="id",
    )
    tabs = tc.build_cand_tables(dt, rt.Camera(*cam), cfgt)
    assert np.array_equal(np.swapaxes(np.asarray(ids), 0, 1), tabs.ids.numpy())
    assert np.array_equal(np.swapaxes(np.asarray(cnt), 0, 1), tabs.counts.numpy())
    # the cull is active: some cell drops part of the scene
    assert int(tabs.counts.min()) < dt.s_pad
    assert tc.seg_max_count(dt, tabs) == int(tabs.counts.max())


def test_narrowed_tables_keep_every_candidate(scenes):
    _, dt = scenes
    cfgt = rt.RenderConfig(rays_per_pixel=RPP, rays_per_block=2048, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfgt)
    gl = tc.seg_max_count(dt, tabs)
    nar = tc.narrow_cand_tables(tabs, gl)
    assert nar.ids.shape[-1] == gl
    assert torch.equal(nar.ids, tabs.ids[..., :gl])
    # every slot past the max count is padding
    assert bool((tabs.ids[..., gl:] == dt.s_pad).all())
