"""The comparison fails what it must: the control (the reference a
precision lower in the program's place) and the timed path broken
underneath, each on a tiny cell with the harness's look for a card skipped.
The faults a cell can have on one chip: a step that returns its state
unchanged, half of the batch (of each pixel's rays) left out with the mean
taken over the rest, and an answer altered where it is produced.  The
cell across cards, whose exchange between ranks can also be left out, has
its own (test_bench_bands.py)."""

import dataclasses

import pytest

from perfbench import core
from perfbench.tests.cells import tiny_root

import raytracingdiffusioncurves_torch.models.renderer as renderer
import raytracingdiffusioncurves_torch.ops.trace_cuda as trace_cuda


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, mode="program"):
    return core.run(core.load_cell(cell, root), seed=2**31 + 3, seconds=0.3, trace=False,
                    dev_name="cpu", mode=mode)


@pytest.mark.parametrize("cell", ["tiny_still", "tiny_zoompan"])
def test_sound_program_is_correct(root, cell):
    assert _run(root, cell)["correct"] is True


@pytest.mark.parametrize("cell", ["tiny_still", "tiny_zoompan"])
def test_control_is_not_correct(root, cell):
    out = _run(root, cell, mode="control")
    assert out["correct"] is False and out["failed"] >= 1


def _state_unchanged(monkeypatch):
    real = renderer.render_frame

    def step(scene, camera, state, config, **kw):
        image, _ = real(scene, camera, state, config, **kw)
        return image, dataclasses.replace(state, frame=state.frame + 1)

    monkeypatch.setattr(renderer, "render_frame", step)


def _half_the_rays(monkeypatch):
    real = trace_cuda.trace_sums_flat

    def trace(scene, camera, config, *a, **kw):
        half = dataclasses.replace(config, rays_per_pixel=max(1, config.rays_per_pixel // 2))
        return real(scene, camera, half, *a, **kw)

    monkeypatch.setattr(trace_cuda, "trace_sums_flat", trace)


def _answer_altered(monkeypatch):
    real = renderer.render_frame

    def altered(*a, **kw):
        image, state = real(*a, **kw)
        return image + 0.01, state

    monkeypatch.setattr(renderer, "render_frame", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_rays, _answer_altered])
@pytest.mark.parametrize("cell", ["tiny_still", "tiny_zoompan"])
def test_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(root, cell)
    assert out["correct"] is False and out["failed"] >= 1
