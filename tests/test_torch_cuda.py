"""The port's CUDA kernels (trace, 3x3 convolution) against their plain
PyTorch versions, on the card.  Skips without a CUDA device (the kernels
have no CPU mode).  Imports neither jax nor the JAX package, so it runs on a
machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Bars: the JAX package's assert_parity (fewer than 3e-5 of image values off
by more than 1e-3, mean below 1e-4) between kernel and plain version — the
two evaluate the same float32 expressions and differ in pow rounding and
the order of the per-pixel sums; kernel with lists == kernel full sweep
bit for bit, with the lists at full length and narrowed to the largest
count (``gather_len``, as the main path passes them).

Convolution: kernel and plain version multiply the same bf16 values and
differ only in the order of the float32 sum: at least 99% of values bitwise
equal, none off by more than one bf16 step of the accumulator plus one of
the result, which is rounded again after the bias
(|diff| <= 2^-7 * (2 |y| + |bias|)).  The denoised frame, kernel route vs
plain route: the network's output is a bf16 residual, so single values move
by one bf16 step (3.9e-3 below 1, 7.8e-3 from 1 to 2): max 1e-2, mean 1e-4.
"""

import os

import pytest
import torch

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.models import denoiser as dn
from raytracingdiffusioncurves_torch.models import renderer
from raytracingdiffusioncurves_torch.ops import conv_cuda as cc
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


@pytest.mark.parametrize("w,h", [(192, 128), (200, 72)], ids=["whole_tiles", "ragged_tiles"])
def test_kernel_matches_plain_at_the_denoised_frames_launch_shape(cuda, w, h):
    """A non-square frame, 8 rays per pixel, the default rays_per_block (2
    wedges, tiles 16 wide and 64 high), a zoomed camera, lists read up to
    seg_max_count: the launch shape of the denoised frame."""
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, w, h)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8)
    cam = rt.Camera(zoom_factor=0.9)
    tabs = tc.build_cand_tables(dt, cam, cfg)
    gl = tc.seg_max_count(dt, tabs)
    kern = tc.trace_sums_flat(dt, cam, cfg, 2, 0, w * h, tabs, gl)
    full = tc.trace_sums_flat(dt, cam, cfg, 2, 0, w * h, None)
    torch.cuda.synchronize()
    for a, b in zip(kern, full):
        assert torch.equal(a, b)
    plain = tc.trace_sums_plain(dt, cam, cfg, 2, 0, w * h, tabs)
    _assert_parity(_images(plain, h, w, cfg), _images(kern, h, w, cfg))


def test_wrapper_rejects_bad_tables(cuda):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)), device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=16, rays_per_block=2048, use_denoiser=False)
    tabs = tc.build_cand_tables(dt, rt.Camera(), cfg)
    bad = tc.CandTables(tabs.ids.to(torch.int64), tabs.counts)
    with pytest.raises(ValueError):
        tc.trace_sums_flat(dt, rt.Camera(), cfg, 0, 0, size * size, bad)


# ---------------------------------------------------------------------------
# 3x3 convolution kernel
# ---------------------------------------------------------------------------

BF = torch.bfloat16
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "denoiser_r3d.msgpack")


def _conv_case(device, seed, h, w, cins, cout, ups):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn((h >> int(u), w >> int(u), c), generator=g).to(BF).to(device)
          for c, u in zip(cins, ups)]
    ks = [(torch.randn((3, 3, c, cout), generator=g) * 0.1).to(BF).to(device) for c in cins]
    b = torch.randn((cout,), generator=g).to(BF).to(device)
    return xs, ks, b


def _assert_conv_close(ref, got, b):
    ref, got = ref.float(), got.float()
    assert ref.shape == got.shape and torch.isfinite(got).all()
    assert float((ref == got).float().mean()) >= 0.99
    step = 2.0**-7 * (2.0 * torch.maximum(ref.abs(), got.abs()) + b.float().abs())
    assert bool(((ref - got).abs() <= step).all())


@pytest.mark.parametrize("h,w,cins,cout,stride,relu,ups", [
    (37, 50, (11,), 24, 1, True, (False,)),       # unaligned Cin, ragged tiles
    (64, 96, (24,), 48, 2, True, (False,)),       # stride 2, even size: pads (0, 1)
    (33, 41, (48,), 96, 2, True, (False,)),       # stride 2, odd size: pads (1, 1)
    (40, 64, (96, 48), 48, 1, True, (True, False)),  # dec1: [up(e2), e1]
    (40, 64, (48, 24), 24, 1, True, (True, False)),  # dec0: [up(d1), e0]
    (35, 70, (24,), 3, 1, False, (False,)),       # out: 3 channels, no ReLU
    (20, 33, (28,), 28, 1, True, (False,)),       # widths of weights/denoiser.msgpack
    (16, 32, (8, 16, 8), 12, 1, False, (False, False, False)),  # three groups
])
def test_conv_kernel_matches_plain(cuda, h, w, cins, cout, stride, relu, ups):
    xs, ks, b = _conv_case(cuda, h * w, h, w, cins, cout, ups)
    cc.reset_launch_count()
    got = cc.conv3x3(xs, ks, b, stride, relu, ups)
    assert cc.LAUNCHES == 1
    torch.cuda.synchronize()
    ref = cc.conv3x3_plain(xs, ks, b, stride, relu, ups)
    assert cc.LAUNCHES == 1
    assert got.dtype == BF and got.is_contiguous()
    _assert_conv_close(ref, got, b)


def test_conv3x3_same_entry(cuda):
    """The one-group entry (the JAX package's conv3x3_same): float32
    operands are cast to bf16."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((23, 37, 11), generator=g).to(cuda)
    k = (torch.randn((3, 3, 11, 24), generator=g) * 0.1).to(cuda)
    b = torch.randn((24,), generator=g).to(cuda)
    got = cc.conv3x3_same(x, k, b)
    ref = cc.conv3x3_plain([x.to(BF)], [k.to(BF)], b.to(BF))
    _assert_conv_close(ref, got, b.to(BF))


def test_conv_wrapper_rejects_non_contiguous(cuda):
    xs, ks, b = _conv_case(cuda, 1, 16, 16, (16,), 8, (False,))
    with pytest.raises(ValueError, match="contiguous"):
        cc.conv3x3([xs[0][:, :, :8]], [ks[0][:, :, :8]], b)


def test_unet_kernel_route_matches_plain_route(cuda):
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda)
    g = torch.Generator().manual_seed(5)
    h, w = 64, 96
    img = torch.cat([torch.rand((h, w, 3), generator=g), torch.ones(h, w, 1)], -1).to(cuda)
    prev = torch.cat([torch.rand((h, w, 3), generator=g), torch.ones(h, w, 1)], -1).to(cuda)
    bmap = torch.rand((h, w), generator=g).to(cuda)
    cc.reset_launch_count()
    a = rt.apply_denoiser(net, img, prev, bmap, noise=0.35, frame=1)
    assert cc.LAUNCHES == 9
    b = dn._apply_denoiser(net, img, prev, bmap, 1.0, 0.35, 1, cc.conv3x3_plain)
    assert cc.LAUNCHES == 9
    d = (a - b).abs()
    assert float(d.max()) < 1e-2 and float(d.mean()) < 1e-4


def test_denoised_frame_on_the_card(cuda):
    size = 64
    dt = rt.build_device_scene(rt.load_scene_from_string(seeded_scene_xml(0, size, size)),
                               device=cuda)
    cfg = rt.RenderConfig(rays_per_pixel=8, rays_per_block=2048)
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=cuda)
    st = rt.init_frame_state(size, size, device=cuda)
    cc.reset_launch_count()
    for _ in range(2):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, denoiser=net)
    assert cc.LAUNCHES == 18
    assert img.shape == (size, size, 4) and torch.isfinite(img).all() and st.flow_is_zero
