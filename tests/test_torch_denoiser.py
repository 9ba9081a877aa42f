"""The port's learned denoiser (``models/denoiser.py``, ``utils/checkpoint.py``)
vs the JAX package, on the shipped checkpoints and seeded numpy inputs.

* The msgpack reader returns the same tree as flax's, bit for bit.
* ``UNetDenoiser`` / ``DenoiserNet`` vs flax ``model.apply``: bar 2e-3 (the
  JAX package's own bar between two orders of the same sums; measured 0:
  the port computes the plain network, layer by layer, with the same
  rounding).
* ``apply_denoiser`` vs JAX's (its default route, the flat-chain Pallas
  forward in interpret mode): bar 5e-3, the JAX package's own bar between
  that route and the plain network (measured 3.9e-3, one bf16 step at ~1,
  from the route's pre-summed dec0 kernel; mean 4e-4), at 24x28 and at
  23x37 (the reflect-pad path), frames 0 and 1.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.models import denoiser as tdn
from raytracingdiffusioncurves_torch.ops import conv_cuda
from raytracingdiffusioncurves_torch.utils import checkpoint
from raytracingdiffusioncurves_tpu.models import denoiser as dn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = os.path.join(ROOT, "weights", "denoiser_r3d.msgpack")
CNN = os.path.join(ROOT, "weights", "denoiser.msgpack")
CHECKPOINTS = pytest.mark.parametrize("path", [UNET, CNN], ids=["unet_r3d", "cnn"])
T = torch.tensor


@CHECKPOINTS
def test_load_params_bitwise_vs_flax(path):
    ours, theirs = rt.load_params(path), dn.load_params(path)
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 0
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_load_params_rejects_damaged_files(tmp_path):
    data = open(CNN, "rb").read()
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.load_params(str(cut))
    tail = tmp_path / "tail.msgpack"
    tail.write_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="after the MessagePack value"):
        checkpoint.load_params(str(tail))
    ext = tmp_path / "ext.msgpack"
    ext.write_bytes(b"\xc7\x01\x05\x00")  # ext 8 of an unknown type
    with pytest.raises(ValueError, match="extension type 5"):
        checkpoint.load_params(str(ext))


@pytest.mark.parametrize("blob", [b"\xc0", b"\xc3", b"\xca\x3f\xc0\x00\x00", b"\xd0\x80",
                                  b"\xff", b"\xd9\x01x", b"\xdc\x00\x00", b"\xde\x00\x00"],
                         ids=["nil", "true", "float32", "int8", "negative_fixint", "str8",
                              "array16", "map16"])
def test_reader_raises_on_forms_no_checkpoint_holds(blob):
    with pytest.raises(ValueError, match="unsupported MessagePack tag"):
        checkpoint._Reader(blob).value()


def test_params_from_jax_and_net_for_params():
    params = rt.load_params(UNET)
    state = rt.params_from_jax(params)
    assert set(state) == {f"{l}.{p}" for l in params["params"] for p in ("kernel", "bias")}
    assert state["dec1.kernel"].shape == (3, 3, 144, 48)
    assert all(v.dtype == torch.float32 for v in state.values())
    np.testing.assert_array_equal(state["enc0a.kernel"].numpy(),
                                  params["params"]["enc0a"]["kernel"])
    net = rt.net_for_params(params, device="cpu")
    assert isinstance(net, rt.UNetDenoiser) and net.base == 24
    assert net.dec1.groups == (96, 48) and net.dec0.groups == (48, 24)
    assert not any(p.requires_grad for p in net.parameters())
    cnn = rt.net_for_params(rt.load_params(CNN), device="cpu")
    assert isinstance(cnn, rt.DenoiserNet) and (cnn.features, cnn.depth) == (28, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.net_for_params(params)


def _net_inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    noisy = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    prev = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    aux = rng.uniform(size=(1, h, w, 2)).astype(np.float32)
    return noisy, prev, aux


@CHECKPOINTS
def test_network_matches_flax_apply(path):
    params = dn.load_params(path)
    model = dn.net_for_params(params)
    net = rt.net_for_params(rt.load_params(path), device="cpu")
    noisy, prev, aux = _net_inputs(11, 24, 28)
    ref = np.asarray(model.apply(params, jnp.asarray(noisy), jnp.asarray(prev), jnp.asarray(aux)))
    got = net(T(noisy), T(prev), T(aux)).numpy()
    assert got.shape == ref.shape == (1, 24, 28, 3)
    assert np.abs(ref - got).max() < 2e-3


def test_unet_matches_flax_apply_random_weights():
    """Widths other than the shipped ones (base 8), weights from a seed."""
    rng = np.random.default_rng(3)
    model = dn.UNetDenoiser(base=8)
    noisy, prev, aux = _net_inputs(4, 16, 24)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(noisy),
                                               jnp.asarray(prev), jnp.asarray(aux)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    ref = np.asarray(model.apply(params, jnp.asarray(noisy), jnp.asarray(prev), jnp.asarray(aux)))
    net = rt.net_for_params(params, device="cpu")
    assert net.base == 8
    got = net(T(noisy), T(prev), T(aux)).numpy()
    assert np.abs(ref - got).max() < 2e-3


def test_unet_rejects_sizes_not_multiple_of_4():
    net = rt.net_for_params(rt.load_params(UNET), device="cpu")
    noisy, prev, aux = _net_inputs(5, 10, 12)
    with pytest.raises(ValueError, match="multiple of 4"):
        net(T(noisy), T(prev), T(aux))


def _frame_inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    img = np.concatenate([rng.uniform(size=(h, w, 3)), np.ones((h, w, 1))], -1).astype(np.float32)
    prev = np.concatenate([rng.uniform(size=(h, w, 3)), np.ones((h, w, 1))], -1).astype(np.float32)
    bmap = rng.uniform(size=(h, w)).astype(np.float32)
    return img, prev, bmap


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("size", [(24, 28), (23, 37)], ids=["24x28", "23x37_padded"])
def test_apply_denoiser_unet_matches_jax(size, frame):
    params = dn.load_params(UNET)
    model = dn.net_for_params(params)
    net = rt.net_for_params(rt.load_params(UNET), device="cpu")
    img, prev, bmap = _frame_inputs(7, *size)
    ref = np.asarray(dn.apply_denoiser(model, params, jnp.asarray(img), jnp.asarray(prev),
                                       jnp.asarray(bmap), noise=0.35, frame=frame))
    got = rt.apply_denoiser(net, T(img), T(prev), T(bmap), noise=0.35, frame=frame).numpy()
    assert got.shape == size + (4,) and np.isfinite(got).all()
    d = np.abs(ref - got)
    assert d.max() < 5e-3 and d.mean() < 1e-3
    np.testing.assert_array_equal(got[..., 3], 1.0)


def test_apply_denoiser_cnn_matches_jax():
    """weights/denoiser.msgpack (the plain residual stack) at an odd size:
    no pad path for it; the JAX side is flax ``model.apply``, bar 2e-3."""
    params = dn.load_params(CNN)
    model = dn.net_for_params(params)
    net = rt.net_for_params(rt.load_params(CNN), device="cpu")
    img, prev, bmap = _frame_inputs(9, 23, 37)
    ref = np.asarray(dn.apply_denoiser(model, params, jnp.asarray(img), jnp.asarray(prev),
                                       jnp.asarray(bmap), noise=0.25, frame=1))
    got = rt.apply_denoiser(net, T(img), T(prev), T(bmap), noise=0.25, frame=1).numpy()
    assert np.abs(ref - got).max() < 2e-3


@CHECKPOINTS
def test_apply_denoiser_mix_zero_returns_input(path):
    """blendFactor = 1 - mix (optixHello.cpp:1131): mix=0 returns the input."""
    net = rt.net_for_params(rt.load_params(path), device="cpu")
    img, prev, bmap = _frame_inputs(13, 16, 16)
    out = rt.apply_denoiser(net, T(img), T(prev), T(bmap), mix=0.0)
    np.testing.assert_allclose(out.numpy(), img, atol=1e-6)


def test_private_route_argument_selects_the_plain_conv():
    """_apply_denoiser's ``conv`` argument names the convolution; on the CPU
    both choices are the plain version, so the results are equal."""
    net = rt.net_for_params(rt.load_params(UNET), device="cpu")
    img, prev, bmap = _frame_inputs(17, 16, 20)
    a = rt.apply_denoiser(net, T(img), T(prev), T(bmap), noise=0.3, frame=2)
    b = tdn._apply_denoiser(net, T(img), T(prev), T(bmap), 1.0, 0.3, 2, conv_cuda.conv3x3_plain)
    assert torch.equal(a, b)


def test_unet_runs_nine_convs_without_concat_or_upsample_copies():
    """Every conv of the UNet goes through the one conv function: 9 calls,
    the decoder's as two groups with the first read through the upsample."""
    net = rt.net_for_params(rt.load_params(UNET), device="cpu")
    calls = []

    def spy(xs, ks, b, stride=1, relu=True, upsample=None):
        calls.append(([tuple(x.shape) for x in xs], stride, relu, upsample))
        return conv_cuda.conv3x3_plain(xs, ks, b, stride, relu, upsample)

    noisy, prev, aux = _net_inputs(19, 16, 24)
    net(T(noisy), T(prev), T(aux), conv=spy)
    assert len(calls) == 9
    assert [c[1] for c in calls] == [1, 1, 2, 1, 2, 1, 1, 1, 1]
    assert calls[6] == ([(4, 6, 96), (8, 12, 48)], 1, True, (True, False))
    assert calls[7] == ([(8, 12, 48), (16, 24, 24)], 1, True, (True, False))
    assert calls[8][2] is False


@CHECKPOINTS
def test_receptive_field_from_the_layers(path):
    """``receptive_field`` works the reach out from the layers: the UNet's
    output row y reads input rows y - 15 .. y + 18 (two stride-2 levels
    whose grids start on rows 0 mod 4, two nearest upsamples), the shipped CNN's
    y - 4 .. y + 4 (four stride-1 layers).  Held against the network: a
    perturbed input row r changes output rows within r - 18 .. r + 15 only,
    and over the four phases of the stride-2 grids the changes reach both
    ends.  ``band_halo``: the wider side plus the bilateral's 2, rounded up
    to a multiple of 4."""
    net = rt.net_for_params(rt.load_params(path), device="cpu")
    up, down = tdn.receptive_field(net)
    assert (up, down) == ((15, 18) if path == UNET else (4, 4))
    assert tdn.band_halo(net) == (20 if path == UNET else 8)
    g = torch.Generator().manual_seed(4)
    x = torch.rand((96, 8, 11), generator=g).to(torch.bfloat16)
    base = net.residual(x, conv_cuda.conv3x3_plain)
    reach = []
    for r in range(40, 44):
        hit = x.clone()
        hit[r] += 8.0 * torch.rand((8, 11), generator=g).to(torch.bfloat16)
        changed = (net.residual(hit, conv_cuda.conv3x3_plain) != base).any(-1).any(-1)
        rows = torch.nonzero(changed)[:, 0]
        reach.append((r - int(rows.min()), int(rows.max()) - r))
    assert all(a <= down and b <= up for a, b in reach), reach
    assert max(a for a, _ in reach) == down and max(b for _, b in reach) == up, reach


def test_noise_level():
    assert rt.models.denoiser.noise_level(16) == dn.noise_level(16) == 0.25


def test_port_imports_no_jax_flax_or_msgpack():
    """No module of the port and not chip_smoke.py imports jax, flax,
    msgpack or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|msgpack|optax|raytracingdiffusioncurves_tpu)\b",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "raytracingdiffusioncurves_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
