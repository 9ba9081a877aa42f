"""The loop across ranks (``loops/still_bands.py``) on a tiny cell: two
gloo ranks on the CPU, 96 x 64, the denoiser off.  Its result line; the
comparison failing the control and the path broken underneath in each
rank (the halo exchange between ranks left out, a state returned
unchanged, half of each pixel's rays left out, the image altered where it
is produced); loop kinds found by file; the denoiser-off reference against the
program's plain path.  Each spawn has a time limit of its own, so a hang
fails."""

import json

import pytest
import torch

from perfbench import core
from perfbench.tests.cells import tiny_root

RANKS_TIMEOUT = 180.0
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, trace=False, rank_setup=None):
    cell = core.load_cell("tiny_bands", root)
    loop = core.load_loop(cell.kind, root)
    return loop.run(cell, SEED, 0.3, trace, "cpu", rank_setup=rank_setup,
                    timeout=RANKS_TIMEOUT)


def test_bands_cell_is_correct_on_two_ranks(root, capfd):
    out = _run(root)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert out["device"]["count"] == 2 and set(out["metrics"]) == {"frame_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    err = capfd.readouterr().err
    ranks = json.loads(next(ln for ln in err.splitlines() if ln.startswith("ranks "))[6:])
    assert [r["frames"] for r in ranks] == [out["attempted"]] * 2
    checked = [json.loads(ln[8:]) for ln in err.splitlines() if ln.startswith("checked ")]
    # the start frame and two of the window, each band across the ranks' edge
    assert [c["kind"] for c in checked] == ["start", "frame", "frame"]
    assert all(c["row"] < 32 < c["row"] + 4 for c in checked)


def _zero_halo():
    """The exchange between ranks left out: every halo row that the
    neighbours send reads 0."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    real = sharded._with_halo

    def zeroed(mesh, bands, halo, align=1):
        regions, top, bottom = real(mesh, bands, halo, align)
        for r in regions:
            r[:top] = 0
            r[r.shape[0] - bottom:] = 0
        return regions, top, bottom

    sharded._with_halo = zeroed


def _state_unchanged():
    """A frame that returns the state it started from (its counter moved)."""
    import dataclasses

    from raytracingdiffusioncurves_torch.parallel import sharded

    real = sharded.render_frame_sharded

    def step(mesh, scene, camera, state, config, **kw):
        image, _ = real(mesh, scene, camera, state, config, **kw)
        return image, dataclasses.replace(state, frame=state.frame + 1)

    sharded.render_frame_sharded = step


def _half_the_rays():
    """Half of each pixel's rays left out, the mean taken over the rest."""
    import dataclasses

    from raytracingdiffusioncurves_torch.ops import trace_cuda

    real = trace_cuda.trace_sums_flat

    def trace(scene, camera, config, *a, **kw):
        half = dataclasses.replace(config, rays_per_pixel=max(1, config.rays_per_pixel // 2))
        return real(scene, camera, half, *a, **kw)

    trace_cuda.trace_sums_flat = trace


def _answer_altered():
    """The band's image altered where it is produced."""
    from raytracingdiffusioncurves_torch.parallel import sharded

    real = sharded.render_frame_sharded

    def altered(*a, **kw):
        image, state = real(*a, **kw)
        return image + 0.01, state

    sharded.render_frame_sharded = altered


@pytest.mark.parametrize("fault", [_zero_halo, _state_unchanged, _half_the_rays,
                                   _answer_altered])
def test_broken_path_is_not_correct(root, fault):
    out = _run(root, rank_setup=fault)
    assert out["correct"] is False and out["failed"] >= 1


def test_control_is_not_correct(root):
    out = core.run(core.load_cell("tiny_bands", root), seed=SEED, seconds=0.3, trace=False,
                   dev_name="cpu", mode="control")
    assert out["correct"] is False and out["failed"] >= 1


def test_traced_run_of_the_bands_cell(root):
    out = _run(root, trace=True)
    assert out["correct"] is True and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the program's count of what the halo exchange gathers: 2 ranks' strips
    # of 2 x 6 rows (the blur's radius), 96 pixels of image and blur map
    assert out["metrics"]["halo_bytes.bands"]["value"] == 2 * 12 * 96 * 5 * 4 * 1e-6
    # no device operations on the CPU: no device metric
    assert not {"trace_kernel_ms.bands", "exchange_ms.bands", "rank_skew.bands",
                "idle_share.bands", "frame_mfu.bands", "trace_roofline.bands"} & set(out["metrics"])


def test_loop_kinds_from_files(root):
    assert core.load_loop("still", root) is core.StillLoop
    assert core.load_loop("session", root) is core.SessionLoop
    assert core.load_loop("still_bands", root).__file__ == str(root / "loops" / "still_bands.py")
    (root / "loops" / "echo.py").write_text("def run(*args):\n    return {'args': args}\n")
    assert core.load_loop("echo", root).run(1, 2) == {"args": (1, 2)}
    with pytest.raises(FileNotFoundError):
        core.load_loop("no_such_kind", root)


def test_plain_band_equals_render_frames_plain_path(root):
    import raytracingdiffusioncurves_torch as rt
    from perfbench.reference import frame as ref
    from perfbench.reference.config import Camera, RenderConfig
    from perfbench.reference.plain_frame import blurred_band

    cell = core.load_cell("tiny_bands", root)
    xml = core.scene_xml(cell.config, SEED)
    settings = core.render_settings(cell.config, SEED)
    dscene = rt.build_device_scene(rt.load_scene_from_string(xml), device="cpu")
    state = rt.init_frame_state(96, 64, device="cpu")
    for _ in range(2):  # frames 0 and 1
        st = state
        image, state = rt.render_frame(dscene, rt.Camera(), st, rt.RenderConfig(**settings))
    scene = ref.load_scene(xml, RenderConfig(**settings), "cpu")
    for r0, r1 in ((0, 4), (29, 33), (60, 64), (0, 64)):
        shown, nxt = blurred_band(scene, Camera(), RenderConfig(**settings), st.frame, r0, r1)
        assert torch.equal(shown, image[r0:r1]) and torch.equal(nxt, state.prev_image[r0:r1])
