"""Row-band multi-device rendering of the port (``parallel/sharded.py``) on
the CPU: two gloo ranks, spawned once for the module (free port, a join
timeout of their own) to run ``torch_sharded_ranks.rank_work`` (no JAX in
the ranks), against one process and against the JAX package's
``trace_image_sharded`` on its 8-device CPU mesh.

Bars.  The sharded path is bitwise equal to one process: each rank traces
its own band with the one-device code (the RNG is keyed on the global ray
id) and post-processes the gathered frame with the one-device tail.  That
holds for the trace, the chained frames (blur, analytic and learned
denoiser), the hoisted per-band tables of a dense capped-list scene, and
the progressive pass.  Against the JAX package: assert_parity (fewer than
3e-5 of values off by more than 1e-3, mean below 1e-4; pow rounding and sum
order).  The data-parallel train step (2 ranks x 2 examples) against the
one-process step on the 4: the loss within 1e-6 relative, gradients within
2^-7 relative L2, parameters within 1e-6 for all but 1% of values (the two
differ in the order of float32 sums and in where the bf16 gradients are
rounded; ``test_data_parallel_train_step`` says why each bar).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytracingdiffusioncurves_torch as rt
import raytracingdiffusioncurves_tpu as rj
from raytracingdiffusioncurves_torch.models import denoiser as tdn
from raytracingdiffusioncurves_torch.ops import trace_cuda as tc
from raytracingdiffusioncurves_torch.parallel import sharded
from raytracingdiffusioncurves_tpu.parallel import sharded as jsharded

from conftest import make_scene_xml, simple_curve
from test_torch_candidates_dense import strokes_xml
from test_torch_trace import assert_parity
from torch_sharded_ranks import (DENSE_CFG, FRAME_CFG, PROG_CFG, ROOT, TRACE_CFG, WEIGHTS,
                                 fail_on_rank_1, new_model, rank_work, scene, seeded,
                                 train_batch)

RANKS_TIMEOUT = 240.0


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module (and one for each spawned rank),
    so that under the suite's parallel workers its ops do not spin against
    the other workers' threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def curve_xml(height=64):
    return make_scene_xml(
        [simple_curve([(10, 14), (30, 25), (40, 40), (50, 52)],
                      left=[(0, "250,40,10"), (10, "20,200,250")],
                      blur=[(0, 0.5), (10, 1.5)])],
        64, height)


@pytest.fixture(scope="module")
def ranks():
    xmls = {"curve": curve_xml(), "odd": curve_xml(63), "dense": strokes_xml()}
    return sharded.spawn_ranks(rank_work, 2, (xmls,), backend="gloo", timeout=RANKS_TIMEOUT)


def test_mesh_and_bands(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == 2 and r["names"] == ("rows",) for r in ranks)
    assert all(r["jax_modules"] == [] for r in ranks)  # the ranks import no JAX
    assert ranks[0]["trace_band"].shape == (32, 64, 4)
    np.testing.assert_array_equal(ranks[0]["trace"][0], ranks[1]["trace"][0])
    np.testing.assert_array_equal(
        np.concatenate([r["trace_band"] for r in ranks]), ranks[0]["trace"][0])


def test_trace_image_sharded_bitwise_and_vs_jax(ranks):
    dt = scene(curve_xml())
    img, bm = rt.trace_image(dt, rt.Camera(), rt.RenderConfig(**TRACE_CFG))
    got_img, got_bm = ranks[0]["trace"]
    np.testing.assert_array_equal(got_img, img.numpy())
    np.testing.assert_array_equal(got_bm, bm.numpy())
    dj = rj.build_device_scene(rj.load_scene_from_string(curve_xml()), flatten_subdivisions=8)
    ij, bj = jsharded.trace_image_sharded(jsharded.make_mesh(2), dj, rj.Camera(),
                                          rj.RenderConfig(**TRACE_CFG), backend="jax")
    assert_parity((np.asarray(ij), np.asarray(bj)), (got_img, got_bm))


def test_render_frame_sharded_bitwise(ranks):
    """Two chained frames with hoisted per-band slot-mode lists (blur, the
    analytic denoiser), then a moved camera with the shipped UNet."""
    dt = seeded()
    cfg = rt.RenderConfig(**FRAME_CFG)
    tabs = rt.build_cand_tables(dt, rt.Camera(), cfg)
    gl = rt.seg_max_count(dt, tabs)
    assert gl is not None and ranks[0]["gather_len"] == ranks[1]["gather_len"] >= gl
    st = rt.init_frame_state(64, 64, device="cpu")
    for i in range(2):
        img, st = rt.render_frame(dt, rt.Camera(), st, cfg, cand_tables=tabs, gather_len=gl)
        np.testing.assert_array_equal(ranks[0]["frames"][i], img.numpy())
    net = rt.net_for_params(rt.load_params(WEIGHTS), device="cpu")
    img, st = rt.render_frame(dt, rt.Camera(1.1, 2.0, -1.0), st, cfg, denoiser=net)
    for r in ranks:
        np.testing.assert_array_equal(r["frames"][2], img.numpy())
        np.testing.assert_array_equal(r["prev"], st.prev_image.numpy())
        assert r["frame"] == st.frame == 3


def test_hoisted_band_tables_on_a_dense_scene(ranks):
    """Per-band capped distance-ordered lists (strokes scene, 768 padded
    sub-segments).  Each rank's band sums equal one process's call on that
    band with its own tables and the full sweep, bit for bit.  The gathered
    frame equals the whole-frame call within 1e-6 (measured: 3 of 16384
    values one float32 step apart): the plain CPU version cuts the rays into
    chunks from the call's first pixel, and PyTorch's CPU kernels round the
    vector body and the tail of a chunk differently, so a pixel's last bit
    can depend on where its band starts; the card's kernel computes each ray
    alone, and chip_smoke.py holds the bands bitwise to the whole frame."""
    assert all(r["dense_dist_ordered"] for r in ranks)
    assert ranks[0]["dense_gather_len"] is None
    dense = scene(strokes_xml())
    cfg = rt.RenderConfig(**DENSE_CFG)
    for rank, r in enumerate(ranks):
        px0 = rank * 32 * 64
        own = tc.trace_sums_flat(dense, rt.Camera(), cfg, 1, px0, 32 * 64,
                                 tc.build_cand_tables(dense, rt.Camera(), cfg, px0, 32 * 64))
        full = tc.trace_sums_flat(dense, rt.Camera(), cfg, 1, px0, 32 * 64, None)
        for got, a, b in zip(r["dense_band"], own, full):
            np.testing.assert_array_equal(got.reshape(-1), a.numpy().reshape(-1))
            np.testing.assert_array_equal(got.reshape(-1), b.numpy().reshape(-1))
    img, bm = rt.trace_image(dense, rt.Camera(), cfg, 1)
    assert np.abs(ranks[1]["dense"][0] - img.numpy()).max() <= 1e-6
    assert np.abs(ranks[1]["dense"][1] - bm.numpy()).max() <= 1e-6
    assert float(img[..., :3].std()) > 0.01


def test_progressive_sharded_bitwise(ranks):
    dt = seeded()
    cfg = rt.RenderConfig(**PROG_CFG)
    st = rt.init_frame_state(64, 64, device="cpu")
    prog = rt.init_progressive_state(64, 64, device="cpu")
    for i, reset in enumerate((True, False, True, False)):
        img, st, prog = rt.render_frame_progressive(dt, rt.Camera(), st, prog, cfg, reset)
        got_img, got_w, passes = ranks[0]["progressive"][i]
        np.testing.assert_array_equal(got_img, img.numpy())
        np.testing.assert_array_equal(got_w, prog.weight_sum.numpy())
        assert passes == prog.passes == (1 if reset else 2)


def test_data_parallel_train_step(ranks):
    """Ranks end the step with the same loss, gradients and parameters; the
    step equals the one-process step on the whole batch: loss within 1e-6
    relative (float32 sums in another order); gradients within 2^-7
    relative L2 per tensor (the bf16 weight and bias gradients are rounded
    per shard, then averaged: measured up to 2.7e-3); parameters within
    1e-6 but for at most 1% of them.  Adam's first update is lr * g / (|g|
    + eps), about +-lr whatever the gradient's size: where a unit's bf16
    pre-activation rounds to 0 in one order of the sum and not in the
    other, its gradient is 0 on one side and tiny on the other, and the
    update lr or 0 (measured: 0.52% of values)."""
    model, sched, opt = new_model()
    loss = tdn.train_step(model, opt, sched, {k: torch.from_numpy(v)
                                              for k, v in train_batch().items()})
    want = tdn.params_to_jax(model)["params"]
    loss_0, params_0, grads_0 = ranks[0]["train"]
    loss_1, params_1, grads_1 = ranks[1]["train"]
    assert loss_0 == loss_1 and abs(loss_0 - float(loss)) <= 1e-6 * float(loss)
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_array_equal(grads_0[name], grads_1[name])
        assert np.linalg.norm(grads_0[name] - g) <= 2.0**-7 * np.linalg.norm(g), name
    off = total = 0
    for name, leaves in want.items():
        for leaf, v in leaves.items():
            got = params_0["params"][name][leaf]
            np.testing.assert_array_equal(got, params_1["params"][name][leaf])
            off += int((np.abs(got - v) > 1e-6).sum())
            total += v.size
    assert off <= 0.01 * total, off / total


def test_height_not_divisible_raises(ranks):
    assert all("not divisible by mesh size 2" in r["odd_height"] for r in ranks)


def test_make_mesh_refuses_more_devices_than_ranks(ranks):
    assert all(r["mesh_of_3"] == "requested 3 devices, have 2 ranks" for r in ranks)


def test_spawn_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        sharded.spawn_ranks(fail_on_rank_1, 2, backend="gloo", timeout=RANKS_TIMEOUT)


def test_cli_devices_2_on_the_cpu(tmp_path):
    xml = tmp_path / "s.xml"
    xml.write_text(curve_xml())
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")  # as few_threads
    outs = {}
    for n in (0, 2):
        png = tmp_path / f"d{n}.png"
        res = subprocess.run(
            [sys.executable, "-m", "raytracingdiffusioncurves_torch", str(xml), "4",
             "--device", "cpu", "--devices", str(n), "--frames", "2", "--out", str(png)],
            capture_output=True, text=True, cwd=tmp_path, env=env, timeout=RANKS_TIMEOUT)
        assert res.returncode == 0, res.stderr
        assert res.stdout.count("Setup took") == res.stdout.count("Average frame time") == 1
        assert res.stdout.count("wrote") == 1
        outs[n] = png.read_bytes()
    assert outs[0] == outs[2]
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "raytracingdiffusioncurves_torch", str(xml), "4",
             "--devices", "2"], capture_output=True, text=True, cwd=tmp_path, env=env,
            timeout=RANKS_TIMEOUT)
        assert res.returncode != 0 and "CUDA" in res.stderr
