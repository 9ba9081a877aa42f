"""The portal loop on one card (``loops/still_portals.py``) on a tiny cell:
the lady_bug class with its portal pair at 64 x 48 and 8 rays per pixel
(1536 sub-segments: capped distance-ordered lists with the horizon
fallback for primary rays, full sweeps for the bounces).  Its result line;
the comparison failing the control and the timed path broken underneath
(``test_bench_plain.py``'s faults, and the portal continuation dropped);
the traced run's program counts; and the portal roofline's count, which
on the scene without its ``connects`` is ``roofline.trace_ops``'s."""

import dataclasses
import json
import re

import pytest
import torch

import raytracingdiffusioncurves_torch.ops.trace_cuda as trace_cuda
from perfbench import core, roofline, roofline_portals, scenes_portals
from perfbench.reference import frame as ref
from perfbench.reference.config import Camera, RenderConfig
from perfbench.tests import test_bench_plain as plain
from perfbench.tests.cells import tiny_root

SEED = 2**31 + 29
RENDER = {"use_aa": True, "use_blur": True, "use_denoiser": False, "exact_silhouettes": True,
          "max_trace_depth": 2}
# what a traced run reads only on the card
ON_CARD = {"trace_kernel_ms.still_portals", "trace_roofline.still_portals",
           "portal_rays.still_portals", "sweep_share.still_portals"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cell ``tiny_portals``: the benchmark's still_portals
    traffic with 2 warm-up frames, the check and limits of
    ``ladybug1080_portals`` on 4-row bands."""
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    traffic = core.read_json(core.BENCH, "traffic", "still_portals")
    (root / "traffic" / "tiny_still_portals.json").write_text(
        json.dumps(dict(traffic, warmup_frames=2)))
    wl = core.read_json(core.BENCH, "workloads", "ladybug1080_portals")
    (root / "configs" / "tiny_portals.json").write_text(json.dumps(dict(
        source="test", reduced=[], scene={"kind": "lady_bug_portals", "seed": 0}, width=64,
        height=48, rays_per_pixel=8, render=RENDER)))
    (root / "workloads" / "tiny_portals.json").write_text(json.dumps(dict(
        wl, config="tiny_portals", traffic="tiny_still_portals", trace_frames=2,
        check=dict(wl["check"], band_rows=4))))
    return root


def _run(root, trace=False, mode="program"):
    return core.run(core.load_cell("tiny_portals", root), seed=SEED, seconds=0.2, trace=trace,
                    dev_name="cpu", mode=mode)


def test_sound_program_is_correct(root, capfd):
    out = _run(root)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms", "setup_s"} and list(out)[-1] == "checks"
    checked = [json.loads(ln[8:]) for ln in capfd.readouterr().err.splitlines()
               if ln.startswith("checked ")]
    assert [c["kind"] for c in checked] == ["frame"]
    # on the CPU the plain path is the reference's, bit for bit
    assert all(c[k] == 0.0 for c in checked for k in core.NUMBERS)


def test_control_is_not_correct(root):
    out = _run(root, mode="control")
    assert out["correct"] is False and out["failed"] >= 1


def _no_portal_bounce(monkeypatch):
    real = trace_cuda.trace_sums_flat

    def trace(scene, camera, config, frame, px_start, n_px, cand_tables=None, gather_len=None):
        flat = dataclasses.replace(config, max_trace_depth=0)
        return real(scene, camera, flat, frame, px_start, n_px, cand_tables, gather_len)

    monkeypatch.setattr(trace_cuda, "trace_sums_flat", trace)


@pytest.mark.parametrize("fault", [plain._state_unchanged, plain._half_the_rays,
                                   plain._answer_altered, _no_portal_bounce])
def test_broken_path_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(root)
    assert out["correct"] is False and out["failed"] >= 1


def test_traced_run_reads_the_programs_portal_count(root, capfd):
    out = _run(root, trace=True)
    assert out["correct"] is True and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the two portal cubics' sub-segments, as the program counts them
    assert out["metrics"]["portal_subsegs.still_portals"] == {"value": 32,
                                                              "unit": "sub-segments"}
    assert "scene_setup_s" in out["metrics"]
    # no device operations on the CPU, no counting launch: no device metric,
    # and none of the still_plain cells' readers
    assert not ON_CARD & set(out["metrics"])
    assert not any(k.endswith(".still_plain") for k in out["metrics"])
    attrs = json.loads(next(ln for ln in capfd.readouterr().err.splitlines()
                            if ln.startswith("program_attrs "))[14:])
    assert attrs["scene.build_device"]["portal_curves"] == 2
    assert attrs["scene.cand_tables"]["order"] == "dist"


def test_the_loop_refuses_another_scene(root):
    cell = core.load_cell("tiny_portals", root)
    cell = dataclasses.replace(cell, config=dict(cell.config, scene={"kind": "lady_bug",
                                                                     "seed": 0}))
    with pytest.raises(ValueError, match="portal scene"):
        core.run(cell, seed=SEED, seconds=0.1, trace=False, dev_name="cpu")


def _counts(xml, rpp=4):
    cfg = RenderConfig(rays_per_pixel=rpp, seed=5, use_denoiser=False)
    scene = ref.load_scene(xml, cfg, "cpu")
    return scene, cfg


def test_portal_roofline_without_connects_is_the_plain_count():
    xml = scenes_portals.portal_dense_scene_xml(0, 96, 64, 5)
    flat, n = re.subn(r' connects="\d+"', "", xml)
    assert n == 2
    scene, cfg = _counts(flat)
    assert not scene.has_portals
    ops, rays, traced = roofline_portals.trace_ops(scene, Camera(), cfg, "cpu")
    assert (ops, rays) == roofline.trace_ops(scene, Camera(), cfg, "cpu")
    assert traced == [rays]


def test_portal_roofline_follows_the_chains():
    xml = scenes_portals.portal_dense_scene_xml(0, 96, 64, 5)
    scene, cfg = _counts(xml)
    assert scene.has_portals
    ops, rays, traced = roofline_portals.trace_ops(scene, Camera(), cfg, "cpu")
    base, _ = roofline.trace_ops(scene, Camera(), cfg, "cpu")
    # every trace counts; the continuations add operations of their own
    assert len(traced) == 3 and traced[0] == rays and 0 < traced[1] < rays
    assert traced[2] <= traced[1] and ops > base
    # the chains are the reference's own: row 32's rays and their exits
    from perfbench.reference import intersect
    pix = torch.arange(32 * 96, 33 * 96).repeat_interleave(4)
    o, d = intersect.make_rays(pix, torch.arange(4).repeat(96), 96, 64, Camera(), cfg, 0)
    h = intersect.trace_and_shade(scene, o, d, cfg)
    assert traced[1] == int((h.hit & h.is_portal).sum())
    counts = roofline_portals.frame_counts(xml, dict(rays_per_pixel=4, seed=5), {
        "zoom": 1.0, "offset_x": 0.0, "offset_y": 0.0}, "cpu")
    assert counts["trace_flop"] == ops and counts["traced"] == traced
    assert counts["trace_bytes"] == (roofline.SEGMENT_BYTES * 1536 + 32 * 32
                                     + roofline.PIXEL_SUM_BYTES * 96 * 64)
