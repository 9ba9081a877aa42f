"""The port's CUDA trace kernel against its plain PyTorch version, on the
card.  Skips without a CUDA device (the kernel has no CPU mode).  Imports
neither jax nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Bars: the JAX package's assert_parity (fewer than 3e-5 of image values off
by more than 1e-3, mean below 1e-4) between kernel and plain version — the
two evaluate the same float32 expressions and differ in pow rounding and
the order of the per-pixel sums; kernel with lists == kernel full sweep
bit for bit, with the lists at full length and narrowed to the largest
count (``gather_len``, as the main path passes them).
"""

import pytest
import torch

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.models import renderer
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.utils.scenes import (
    portal_weights_scene_xml,
    seeded_scene_xml,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace kernel runs only on the card")
    return torch.device("cuda")


def _images(sums, h, w, cfg):
    c, wt, b = sums
    return renderer.normalize_sums(c.reshape(h, w, 3), wt.reshape(h, w), b.reshape(h, w), cfg)


def _assert_parity(ref, got):
    (ia, ba), (ib, bb) = ref, got
    d = (ia - ib).abs()
    assert not torch.isnan(ib).any()
    assert float((d > 1e-3).float().mean()) < 3e-5 and float(d.mean()) < 1e-4
    assert float(((ba - bb).abs() > 1e-3).float().mean()) < 3e-5


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_matches_plain_with_lists(cuda, exact, narrow):
    size = 256
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(1, size, size)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=32, rays_per_block=2048, use_denoiser=False,
                          exact_silhouettes=exact)
    cam = rt.Camera(0.8, 3.0, -5.0)
    tabs = tc.build_cand_tables(dt, cam, cfg)
    assert tabs is not None
    gl = None
    if narrow:
        gl = tc.seg_max_count(dt, tabs)
        assert gl < tabs.ids.shape[-1]
        tabs = tc.narrow_cand_tables(tabs, gl)
    tc.reset_launch_count()
    kern = tc.trace_sums_flat(dt, cam, cfg, 3, 0, size * size, tabs, gl)
    assert tc.LAUNCHES == 1
    full = tc.trace_sums_flat(dt, cam, cfg, 3, 0, size * size, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    plain = tc.trace_sums_plain(dt, cam, cfg, 3, 0, size * size, tabs)
    _assert_parity(_images(plain, size, size, cfg), _images(kern, size, size, cfg))


def test_kernel_matches_plain_portals_weights(cuda):
    size = 128
    dt = rt.build_device_scene(rt.load_scene_from_string(portal_weights_scene_xml(size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=16, rays_per_block=2048, use_denoiser=False)
    kern = tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size)
    plain = tc.trace_sums_plain(dt, rt.Camera(), cfg, 0, 0, size * size)
    _assert_parity(_images(plain, size, size, cfg), _images(kern, size, size, cfg))


def test_wrapper_rejects_bad_tables(cuda):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=16, rays_per_block=2048, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    bad = tc.CandTables(tabs.ids.to(torch.int64), tabs.counts)
    with pytest.raises(ValueError):
        tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size, bad)
