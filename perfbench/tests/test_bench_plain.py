"""The denoiser-off loop on one card (``loops/still_plain.py``) on tiny
cells: the endcapped arch class at 96 x 64 and 16 rays per pixel (256
sub-segments: distance-ordered lists), and the endcap-free class through
the same loop.  Its result line; the comparison failing the control and
the timed path broken underneath (a state returned unchanged, half of each
pixel's rays left out, the image altered where it is produced); the
traced run's program counts, and none where the program records no
spans."""

import dataclasses
import json

import pytest

import raytracingdiffusioncurves_torch.models.renderer as renderer
import raytracingdiffusioncurves_torch.ops.trace_cuda as trace_cuda
from perfbench import core, stages
from perfbench.tests.cells import tiny_root

SEED = 2**31 + 13
RENDER = {"use_aa": True, "use_blur": True, "use_denoiser": False, "exact_silhouettes": True}
# what a traced run reads only on the card
ON_CARD = {"trace_kernel_ms.still_plain", "trace_roofline.still_plain", "frame_mfu.still_plain",
           "torch_ops_ms.still_plain", "idle_share.still_plain",
           "trace_slots_per_ray.still_plain", "trace_lane_use.still_plain"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells ``tiny_endcapped`` and ``tiny_seeded_plain``: the
    benchmark's still_plain traffic with 2 warm-up frames, the check and
    limits of ``arch1024_still`` on 4-row bands."""
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    traffic = core.read_json(core.BENCH, "traffic", "still_plain")
    (root / "traffic" / "tiny_still_plain.json").write_text(
        json.dumps(dict(traffic, warmup_frames=2)))
    wl = core.read_json(core.BENCH, "workloads", "arch1024_still")
    for name, kind in (("tiny_endcapped", "endcapped"), ("tiny_seeded_plain", "seeded")):
        (root / "configs" / f"{name}.json").write_text(json.dumps(dict(
            source="test", reduced=[], scene={"kind": kind, "seed": 0}, width=96, height=64,
            rays_per_pixel=16, render=RENDER)))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(dict(
            wl, config=name, traffic="tiny_still_plain", trace_frames=2,
            check=dict(wl["check"], band_rows=4, frames={"any": 2}))))
    return root


def _run(root, cell="tiny_endcapped", trace=False, mode="program"):
    return core.run(core.load_cell(cell, root), seed=SEED, seconds=0.2, trace=trace,
                    dev_name="cpu", mode=mode)


@pytest.mark.parametrize("cell", ["tiny_endcapped", "tiny_seeded_plain"])
def test_sound_program_is_correct(root, cell, capfd):
    out = _run(root, cell)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms", "setup_s"} and list(out)[-1] == "checks"
    checked = [json.loads(ln[8:]) for ln in capfd.readouterr().err.splitlines()
               if ln.startswith("checked ")]
    assert [c["kind"] for c in checked][0] == "start" and len(checked) >= 2
    # on the CPU the plain path is the reference's, bit for bit
    assert all(c[k] == 0.0 for c in checked for k in core.NUMBERS)


def test_control_is_not_correct(root):
    out = _run(root, mode="control")
    assert out["correct"] is False and out["failed"] >= 1


def _state_unchanged(monkeypatch):
    real = renderer.render_frame

    def step(scene, camera, state, config, **kw):
        image, _ = real(scene, camera, state, config, **kw)
        return image, dataclasses.replace(state, frame=state.frame + 1)

    monkeypatch.setattr(renderer, "render_frame", step)


def _half_the_rays(monkeypatch):
    real = trace_cuda.trace_sums_flat

    def trace(scene, camera, config, frame, px_start, n_px, cand_tables=None, gather_len=None):
        # the full sweep: the hoisted tables' wedges are the whole fan's
        half = dataclasses.replace(config, rays_per_pixel=max(1, config.rays_per_pixel // 2))
        return real(scene, camera, half, frame, px_start, n_px)

    monkeypatch.setattr(trace_cuda, "trace_sums_flat", trace)


def _answer_altered(monkeypatch):
    real = renderer.render_frame

    def altered(*a, **kw):
        image, state = real(*a, **kw)
        return image + 0.01, state

    monkeypatch.setattr(renderer, "render_frame", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_rays, _answer_altered])
def test_broken_path_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(root)
    assert out["correct"] is False and out["failed"] >= 1


def test_traced_run_reads_the_programs_endcap_count(root, capfd):
    out = _run(root, trace=True)
    assert out["correct"] is True and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the eight endcap loops' sub-segments, as the program counts them
    assert out["metrics"]["endcap_subsegs.still_plain"] == {"value": 128, "unit": "sub-segments"}
    assert "scene_setup_s" in out["metrics"]
    # no device operations on the CPU, no counting launch: no device metric;
    # stages.py's window (built-in loops only) reads nothing here
    assert not (ON_CARD | {"scene_build_s"}) & set(out["metrics"])
    attrs = json.loads(next(ln for ln in capfd.readouterr().err.splitlines()
                            if ln.startswith("program_attrs "))[14:])
    assert attrs["scene.cand_tables"] == {"table_kind": "seg", "order": "dist", "cand_len": 256,
                                          "wedges": 4, "wedge_shift": 0}
    assert stages.recorder()._on is False


def test_without_the_programs_counts_the_metric_is_left_out(root, monkeypatch):
    # a program that records no spans (or none with attributes): no count
    monkeypatch.setattr(stages, "recorder", lambda: None)
    out = _run(root, trace=True)
    assert out["correct"] is True and "endcap_subsegs.still_plain" not in out["metrics"]


def test_the_loop_refuses_a_denoised_config(root):
    cell = core.load_cell("tiny_endcapped", root)
    cell = dataclasses.replace(cell, config=dict(cell.config, render=dict(RENDER,
                                                                         use_denoiser=True)))
    with pytest.raises(ValueError, match="denoiser off"):
        core.run(cell, seed=SEED, seconds=0.1, trace=False, dev_name="cpu")
