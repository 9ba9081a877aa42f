"""The port's denoiser trainer (``models/train_denoiser.py``, the training
half of ``models/denoiser.py``, the checkpoint writer) vs the JAX package,
on the CPU with seeded numpy inputs.

Bars, each with its reason:

* ``sample_example`` at 32^2 (rpp 4 / 16): the same cameras (the numpy RNG
  is left in the same state), renders at the JAX package's assert_parity
  bars (fewer than 3e-5 of values off by more than 1e-3, mean below 1e-4:
  pow rounding and sum order of the trace); the port's zoom flow and warp
  applied to JAX's previous frame within 1e-6 of JAX's warp (the same
  float32 bilinear taps).
* ``_crop_batch``: bitwise (the same draws, copies of the same float16
  values).
* ``generate`` on two 16^2 scenes: every value of the .npz within one
  float16 step of JAX's (renders agree to ~1e-6; rounding to float16 can
  fall on either side of a step).
* Init: every kernel within +-2 sigma of flax's lecun_normal (sigma =
  sqrt(1 / fan_in) / 0.8796), standard deviation within 6% of sqrt(1 /
  fan_in) and of flax's own draws, mean within 5 standard errors, biases 0.
* ``loss_fn`` at parameters carried over by ``params_from_jax``: within
  1e-3 relative (measured 1e-5: bf16 convolutions summed in another order).
* Gradients, relative L2 per tensor.  Kernels: 3e-2 (measured up to
  1.9e-2: bf16 activations and cotangents rounded after sums taken in
  another order).  Biases are held to the exact sum of the same bf16
  cotangents instead (within 2^-8, one bf16 rounding of the sum): XLA's CPU
  backend reduces the bf16 cotangent of a broadcast add in bf16, and such a
  sum stops growing once a term falls below half a bf16 step of it (pinned
  below), so JAX's bias gradients are no reference.
* Adam + the cosine schedule fed JAX's own gradients for 3 steps:
  parameters within 1e-6 of optax's (the same float32 update formula, a
  few roundings apart); the schedule within 1e-6 relative.
* Checkpoints: bytes equal to ``flax.serialization.to_bytes``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.models import denoiser as tdn
from raytracingdiffusioncurves_torch.models import train_denoiser as ttd
from raytracingdiffusioncurves_torch.ops import conv_cuda
from raytracingdiffusioncurves_torch.utils import checkpoint
from raytracingdiffusioncurves_tpu.models import denoiser as jdn
from raytracingdiffusioncurves_tpu.models import train_denoiser as jtd
from raytracingdiffusioncurves_tpu.ops import flow as jflow

from conftest import make_scene_xml, simple_curve
from test_torch_trace import assert_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.tensor


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module, so that under the suite's
    parallel workers its ops do not spin against the other workers'
    threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _curve_xml(size, shift=0.0):
    return make_scene_xml(
        [simple_curve([(10 + shift, 14), (30, 25 + shift), (40, 40), (50, 52)],
                      left=[(0, "250,40,10"), (10, "20,200,250")],
                      blur=[(0, 0.5), (10, 1.5)])],
        size, size)


def test_sample_example_matches_jax():
    xml = _curve_xml(32)
    dj = rj.build_device_scene(rj.load_scene_from_string(xml), flatten_subdivisions=8)
    dt = rt.build_device_scene(rt.load_scene_from_string(xml), flatten_subdivisions=8,
                               device="cpu")
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    bj = jtd.sample_example(dj, rng_j, 32, "jax", frame=3, rpp_lo=4, rpp_hi=16)
    bt = ttd.sample_example(dt, rng_t, 32, frame=3, rpp_lo=4, rpp_hi=16)
    assert rng_j.bit_generator.state == rng_t.bit_generator.state
    assert set(bt) == set(bj)
    for k in bj:
        assert tuple(bt[k].shape) == tuple(bj[k].shape) and bt[k].dtype == torch.float32
    blur_j, blur_t = np.asarray(bj["aux"][0, ..., 0]), bt["aux"][0, ..., 0].numpy()
    for k in ("noisy", "target", "warped_prev"):
        assert_parity((np.asarray(bj[k][0]), blur_j), (bt[k][0].numpy(), blur_t))
    np.testing.assert_array_equal(bt["aux"][0, ..., 1].numpy(), np.asarray(bj["aux"][0, ..., 1]))
    # the warp on the same previous frame: JAX's, from the camera both drew
    rng = np.random.default_rng(5)
    zoom = float(np.exp(rng.uniform(np.log(0.3), np.log(2.0))))
    off = rng.uniform(-100, 100, 2)
    lo = rj.RenderConfig(rays_per_pixel=4, use_blur=False, use_denoiser=False, seed=3)
    prev, _ = rj.trace_image(dj, rj.Camera(zoom * 1.1, float(off[0]), float(off[1])), lo, 4,
                             backend="jax")
    fl_j = jflow.add_zoom_flow(jflow.zero_flow(32, 32), zoom * 1.1, zoom)
    want = np.asarray(jflow.warp_by_flow(prev, fl_j))
    fl_t = rt.add_zoom_flow(rt.zero_flow(32, 32, device="cpu"), zoom * 1.1, zoom)
    got = rt.warp_by_flow(T(np.asarray(prev)), fl_t).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _f16_data(seed, n=4, h=12, w=10):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(size=(n, h, w, c)).astype(np.float16)
            for k, c in (("noisy", 3), ("warped_prev", 3), ("aux", 2), ("target", 3))}


def test_crop_batch_bitwise():
    data = _f16_data(0)
    bj = jtd._crop_batch(data, np.random.default_rng(9), 7, 6)
    bt = ttd._crop_batch(data, np.random.default_rng(9), 7, 6, device="cpu")
    assert list(bt) == list(bj)
    for k in bj:
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))


def test_generate_matches_jax_and_trains(tmp_path):
    """Both packages' datasets from the same two scenes and seed, then the
    port trains two steps on the JAX package's file."""
    names = []
    for i in range(2):
        path = tmp_path / f"scene{i}.xml"
        path.write_text(_curve_xml(16, shift=3.0 * i))
        names.append(str(path))
    out_j, out_t = tmp_path / "jax.npz", tmp_path / "torch.npz"
    jtd.generate(names, str(out_j), size=16, cams_per_scene=1, seed=1, backend="jax")
    ttd.generate(names, str(out_t), size=16, cams_per_scene=1, seed=1, device="cpu")
    with np.load(out_j) as zj, np.load(out_t) as zt:
        assert sorted(zj.files) == sorted(zt.files) == ["aux", "noisy", "target", "warped_prev"]
        for k in zj.files:
            a, b = zj[k], zt[k]
            assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
            step = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
            assert np.all(np.abs(a.astype(np.float32) - b.astype(np.float32)) <= step), k
    assert sorted(os.listdir(str(out_t) + ".shards")) == sorted(os.listdir(str(out_j) + ".shards"))
    res = ttd.train(str(out_j), str(out_j), str(tmp_path / "p.msgpack"), steps=2, batch=2,
                    crop=8, arch="unet", base=4, device="cpu")
    assert np.isfinite(res["loss"]) and res["best_val_psnr"] > 0
    assert set(jdn.load_params(str(tmp_path / "p.msgpack"))["params"]) >= {"enc0a", "out"}


@pytest.mark.parametrize("arch", ["cnn", "unet"])
def test_init_statistics(arch):
    model, _, _ = tdn.create_train_state(torch.Generator().manual_seed(0), 16, 16, arch=arch,
                                         device="cpu")
    again, _, _ = tdn.create_train_state(torch.Generator().manual_seed(0), 16, 16, arch=arch,
                                         device="cpu")
    jm = jdn.UNetDenoiser() if arch == "unet" else jdn.DenoiserNet()
    x = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, x, jnp.zeros((1, 16, 16, 2))))
    jparams = shapes["params"]
    layers = tdn.params_to_jax(model)["params"]
    assert set(layers) == set(jparams)
    lecun = jax.nn.initializers.lecun_normal()
    for i, (name, leaves) in enumerate(layers.items()):
        k = leaves["kernel"]
        assert k.shape == jparams[name]["kernel"].shape and k.dtype == np.float32
        assert leaves["bias"].shape == jparams[name]["bias"].shape
        kj = np.asarray(lecun(jax.random.key(i), k.shape, jnp.float32))
        np.testing.assert_array_equal(leaves["bias"], 0.0)
        fan_in = 9 * k.shape[2]
        want = np.sqrt(1.0 / fan_in)
        assert np.abs(k).max() <= 2.0 * want / 0.87962566103423978 * (1 + 1e-6)
        assert abs(k.std() / want - 1.0) < 0.06, (name, k.std() / want)
        assert abs(k.std() / kj.std() - 1.0) < 0.06
        assert abs(k.mean()) < 5.0 * want / np.sqrt(k.size)
        np.testing.assert_array_equal(getattr(again, name).kernel.detach().numpy(), k)


def _models(arch):
    """(flax module, its params, the port's module with them) at small widths:
    the CNN at features 8, depth 2; the UNet at base 8."""
    if arch == "cnn":
        jm, tm = jdn.DenoiserNet(features=8, depth=2), tdn.DenoiserNet(features=8, depth=2)
    else:
        jm, tm = jdn.UNetDenoiser(base=8), tdn.UNetDenoiser(base=8)
    x = jnp.zeros((1, 16, 16, 3))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(4), x, x, jnp.zeros((1, 16, 16, 2))))
    tm.load_state_dict(tdn.params_from_jax(params))
    return jm, params, tm


def _batch(seed, n=4, size=16):
    rng = np.random.default_rng(seed)
    target = rng.uniform(size=(n, size, size, 3)).astype(np.float32)
    return {
        "noisy": (target + 0.2 * rng.standard_normal(target.shape)).astype(np.float32),
        "warped_prev": rng.uniform(size=(n, size, size, 3)).astype(np.float32),
        "aux": rng.uniform(size=(n, size, size, 2)).astype(np.float32),
        "target": target,
    }


_GRAD_FNS = {}  # one compile per flax module (modules compare by value)


def _jax_value_and_grad(jm, params, batch):
    fn = _GRAD_FNS.get(jm)
    if fn is None:
        fn = _GRAD_FNS[jm] = jax.jit(jax.value_and_grad(lambda p, b: jdn.loss_fn(jm, p, b)))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("arch", ["cnn", "unet"])
def test_loss_and_gradients_match_jax(arch, monkeypatch):
    jm, params, tm = _models(arch)
    batch = _batch(1)
    loss_j, grads_j = _jax_value_and_grad(jm, params, batch)
    # keep each layer's bf16 output before ReLU, to read its cotangent
    outs = []
    real = tdn.conv3x3_train

    def spy(xs, ks, b, stride=1, relu=True, upsample=None):
        y = real(xs, ks, b, stride, False, upsample)
        y.retain_grad()
        outs.append(y)
        return torch.relu(y) if relu else y

    monkeypatch.setattr(tdn, "conv3x3_train", spy)
    loss_t = tdn.loss_fn(tm, {k: T(v) for k, v in batch.items()})
    loss_t.backward()
    assert abs(float(loss_t.detach()) - loss_j) <= 1e-3 * abs(loss_j)
    layers = [name for name, _ in tdn._conv_layers(tm)]
    assert len(outs) == len(layers)
    for name, y in zip(layers, outs):
        layer = getattr(tm, name)
        gj = grads_j["params"][name]["kernel"]
        gt = layer.kernel.grad.numpy()
        assert np.linalg.norm(gt - gj) <= 3e-2 * np.linalg.norm(gj), name
        exact = y.grad.double().sum((0, 1, 2)).numpy()
        gb = layer.bias.grad.double().numpy()
        assert np.linalg.norm(gb - exact) <= 2.0**-8 * np.linalg.norm(exact), name


def test_jax_reduces_a_bf16_broadcast_cotangent_in_bf16():
    """Why bias gradients are held to the exact sum: JAX's cotangent of a
    bf16 broadcast add over 1024 positions, reduced on the CPU, stops at
    0.125 where the 1024 terms of 2^-11 add up to 0.5 (a term is then half
    a bf16 step of the sum); torch's sum of the same bf16 values is exact.
    On random-signed terms JAX is ~3% off."""
    g = jnp.full((4, 16, 16, 3), 2.0**-11, jnp.bfloat16)
    _, vjp = jax.vjp(lambda b: jnp.zeros((4, 16, 16, 3), jnp.bfloat16) + b,
                     jnp.zeros(3, jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(vjp(g)[0].astype(jnp.float32)), 0.125)
    torch_sum = torch.full((4, 16, 16, 3), 2.0**-11).to(torch.bfloat16).sum((0, 1, 2))
    np.testing.assert_array_equal(torch_sum.float().numpy(), 0.5)
    r = np.random.default_rng(0).standard_normal((4, 16, 16, 3)).astype(np.float32) * 1e-3
    rb = jnp.asarray(r).astype(jnp.bfloat16)
    exact = np.asarray(rb.astype(jnp.float32), np.float64).sum((0, 1, 2))
    jax_sum = np.asarray(vjp(rb)[0].astype(jnp.float32), np.float64)
    assert np.linalg.norm(jax_sum - exact) > 1e-2 * np.linalg.norm(exact)


def test_adam_and_cosine_schedule_match_optax():
    """Both optimizers fed JAX's own gradients for 3 steps (the UNet at base
    8, the JAX parameters after each update)."""
    jm, params, _ = _models("unet")
    tx = optax.adam(optax.cosine_decay_schedule(2e-3, 10, alpha=0.1))
    opt_state = tx.init(params)
    model, sched, opt = tdn.create_train_state(
        torch.Generator().manual_seed(0), 16, 16, tdn.cosine_decay_schedule(2e-3, 10, alpha=0.1),
        arch="unet", base=8, device="cpu")
    model.load_state_dict(tdn.params_from_jax(params))
    p_j = params
    for step in range(3):
        _, grads = _jax_value_and_grad(jm, p_j, _batch(10 + step))
        updates, opt_state = tx.update(grads, opt_state, p_j)
        p_j = jax.tree_util.tree_map(np.asarray, optax.apply_updates(p_j, updates))
        for name, layer in tdn._conv_layers(model):
            for leaf in ("kernel", "bias"):
                getattr(layer, leaf).grad = T(grads["params"][name][leaf])
        opt.step()
        sched.step()
    got = tdn.params_to_jax(model)["params"]
    for name, leaves in got.items():
        for leaf, v in leaves.items():
            assert np.abs(v - p_j["params"][name][leaf]).max() <= 1e-6, (name, leaf)
    assert sched.last_epoch == 3


def test_cosine_schedule_values():
    sched_j = optax.cosine_decay_schedule(2e-3, 10, alpha=0.1)
    sched_t = tdn.cosine_decay_schedule(2e-3, 10, alpha=0.1)
    for count in (0, 1, 3, 5, 9, 10, 11, 40):
        want = float(sched_j(count))
        assert abs(sched_t(count) - want) <= 1e-6 * want, count
    _, sched, opt = tdn.create_train_state(torch.Generator().manual_seed(0), 8, 8, sched_t,
                                          device="cpu")
    for count in range(4):
        assert opt.param_groups[0]["lr"] == sched_t(count)
        opt.step()
        sched.step()


def test_train_step_reduces_loss_on_fixed_batch():
    """The JAX package's test (tests/test_denoiser.py): 30 steps on one
    fixed batch bring the loss under 0.7x the first."""
    model, sched, opt = tdn.create_train_state(torch.Generator().manual_seed(0), 32, 32, lr=3e-3,
                                            device="cpu")
    rng = np.random.default_rng(1)
    target = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    batch = {"noisy": T(target + 0.2 * rng.standard_normal(target.shape).astype(np.float32)),
             "warped_prev": T(target), "aux": torch.zeros(2, 32, 32, 2), "target": T(target)}
    first = float(tdn.loss_fn(model, batch).detach())
    for _ in range(30):
        loss = tdn.train_step(model, opt, sched, batch)
    assert float(loss) < 0.7 * first
    assert sched.last_epoch == 30


def test_batched_forward_equals_per_image():
    """forward_batch (conv3x3_train, the batched bilateral) against the
    per-image inference forward on the plain convolution: the batched
    analytic baseline is bitwise the per-image one; the networks' outputs
    meet the convolution bar through nine layers (values of a bf16 residual:
    at most two bf16 steps of ~1, measured 0)."""
    _, _, tm = _models("unet")
    b = {k: T(v) for k, v in _batch(2, n=3).items()}
    base = tdn.analytic_baseline(b["noisy"], b["warped_prev"])
    loop = torch.stack([tdn.analytic_baseline(n, p) for n, p in zip(b["noisy"], b["warped_prev"])])
    assert torch.equal(base, loop)
    with torch.no_grad():
        got = tm.forward_batch(b["noisy"], b["warped_prev"], b["aux"])
        want = tm(b["noisy"], b["warped_prev"], b["aux"], conv=conv_cuda.conv3x3_plain)
    assert (got - want).abs().max() <= 2 * 2.0**-7


@pytest.mark.parametrize("layer", range(9))
def test_conv3x3_train_matches_plain(layer):
    """conv3x3_train on a batch against conv3x3_plain per image at the UNet's
    layer shapes (base 8, 16^2), under the convolution kernel's bar: at
    least 99% of values bitwise equal, |diff| <= 2^-7 (2|y| + |b|)."""
    c = 8
    shapes = [((11,), c, 1, (False,)), ((c,), c, 1, (False,)), ((c,), 2 * c, 2, (False,)),
              ((2 * c,), 2 * c, 1, (False,)), ((2 * c,), 4 * c, 2, (False,)),
              ((4 * c,), 4 * c, 1, (False,)), ((4 * c, 2 * c), 2 * c, 1, (True, False)),
              ((2 * c, c), c, 1, (True, False)), ((c,), 3, 1, (False,))]
    sizes = [16, 16, 16, 8, 8, 4, 8, 16, 16]
    cins, cout, stride, ups = shapes[layer]
    h = sizes[layer]
    rng = np.random.default_rng(layer)
    bf = torch.bfloat16
    xs = [T(rng.standard_normal((3, h >> int(u), h >> int(u), ci)).astype(np.float32)).to(bf)
          for ci, u in zip(cins, ups)]
    ks = [T(0.2 * rng.standard_normal((3, 3, ci, cout)).astype(np.float32)).to(bf) for ci in cins]
    b = T(rng.standard_normal(cout).astype(np.float32)).to(bf)
    got = tdn.conv3x3_train(xs, ks, b, stride, True, ups).float()
    want = torch.stack([conv_cuda.conv3x3_plain([x[i] for x in xs], ks, b, stride, True, ups)
                        for i in range(3)]).float()
    assert got.shape == want.shape
    d = (got - want).abs()
    assert float((d == 0).float().mean()) >= 0.99
    assert bool((d <= 2.0**-7 * (2 * torch.maximum(got.abs(), want.abs()) + b.float().abs())).all())


def _port_tree(arch, base):
    model, _, _ = tdn.create_train_state(torch.Generator().manual_seed(2), 8, 8, arch=arch,
                                         base=base, device="cpu")
    return model, tdn.params_to_jax(model)


@pytest.mark.parametrize("arch,base", [("unet", 8), ("cnn", 6)])
def test_checkpoint_bytes_equal_flax(arch, base, tmp_path):
    model, tree = _port_tree(arch, base)
    state = tdn.params_from_jax(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v)
    data = checkpoint.params_to_bytes(tree)
    assert data == serialization.to_bytes(tree)
    path = checkpoint.save_params(str(tmp_path / "p.msgpack"), tree)
    loaded = jdn.load_params(path)
    for name, leaves in tree["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(np.asarray(loaded["params"][name][leaf]), v)
    net = jdn.net_for_params(loaded)
    assert type(net).__name__ == {"unet": "UNetDenoiser", "cnn": "DenoiserNet"}[arch]


def test_checkpoint_bytes_of_shipped_files_and_unsorted_trees():
    for name in ("denoiser_r3d.msgpack", "denoiser.msgpack"):
        path = os.path.join(ROOT, "weights", name)
        raw = open(path, "rb").read()
        assert checkpoint.params_to_bytes(rt.load_params(path)) == raw
    tree = {"z": {"kernel": np.arange(6, dtype=np.float32).reshape(1, 2, 3),
                  "bias": np.ones(300, np.float32)},
            "a": {"w": np.zeros((200, 70), np.float32)}}
    assert checkpoint.params_to_bytes(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("tree,err", [
    ({"s": np.zeros((), np.float32)}, ValueError),  # a 16-byte payload: fixext
    ({"k" * 32: np.zeros(3, np.float32)}, ValueError),
    ({str(i): np.zeros(3, np.float32) for i in range(16)}, ValueError),
    ({"x": 1.5}, TypeError),
], ids=["fixext", "long_key", "map16", "float_leaf"])
def test_checkpoint_writer_raises_on_forms_the_reader_does_not_read(tree, err):
    with pytest.raises(err):
        checkpoint.params_to_bytes(tree)


def test_reference_scenes_resolve_inside_the_checkout(tmp_path):
    """``XMLS`` lies inside the checkout; while the reference XMLs are not
    there, ``gen`` with its default scenes fails before it renders or
    writes anything."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert ttd.XMLS == os.path.join(root, "reference", "optixHello", "xmls")
    if not os.path.isdir(ttd.XMLS):
        with pytest.raises(FileNotFoundError, match="arch.xml"):
            ttd.main(["gen", "--out", str(tmp_path / "d.npz"), "--device", "cpu"])
        assert os.listdir(tmp_path) == []


def test_create_train_state_places_the_model():
    """The same weights on every device; the default device is the card."""
    model, _, opt = tdn.create_train_state(torch.Generator().manual_seed(0), 8, 8,
                                           arch="unet", base=4, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert opt.param_groups[0]["params"][0] is next(model.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdn.create_train_state(torch.Generator().manual_seed(0), 8, 8)


def test_main_gen_and_train(tmp_path, monkeypatch):
    """``main(["gen", ...])`` and ``main(["train", ...])`` on a tiny set,
    with --device cpu; the default device is the card."""
    for name, shift in (("arch.xml", 0.0), ("line.xml", 4.0)):
        (tmp_path / name).write_text(_curve_xml(16, shift))
    monkeypatch.setattr(ttd, "XMLS", str(tmp_path))
    data = str(tmp_path / "d.npz")
    ttd.main(["gen", "--out", data, "--size", "16", "--cams", "2", "--scenes",
              "arch.xml,line.xml", "--device", "cpu"])
    with np.load(data) as z:
        assert z["noisy"].shape == (4, 16, 16, 3) and z["aux"].dtype == np.float16
    shards = sorted(os.listdir(data + ".shards"))
    assert shards == ["00_arch.000.npz", "04_line.000.npz"]
    ckpt = str(tmp_path / "p.msgpack")
    ttd.main(["train", "--data", data, "--val", data, "--out", ckpt, "--steps", "3",
              "--batch", "2", "--crop", "8", "--arch", "unet", "--base", "4", "--device", "cpu"])
    net = rt.net_for_params(rt.load_params(ckpt), device="cpu")
    assert isinstance(net, rt.UNetDenoiser) and net.base == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttd.main(["train", "--data", data, "--out", ckpt, "--steps", "1"])
