"""The port's MJPEG HTTP viewer on the CPU, after tests/test_viewer_http.py:
the page and single-frame endpoints, the stream, event posts applied with
InteractiveSession semantics, the screenshot round trip, and an error in
the render thread surfacing in wait_frame.  Every wait has a timeout."""

import json
import urllib.request

import pytest

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.viewer import ZOOM_STEP, InteractiveSession
from raytracingdiffusioncurves_torch.viewer_http import HttpViewer

from conftest import make_scene_xml, simple_curve

TIMEOUT = 60


def _session():
    xml = make_scene_xml([simple_curve([(10, 14), (30, 25), (40, 40), (50, 52)])])
    dev = rt.build_device_scene(rt.load_scene_from_string(xml), flatten_subdivisions=8,
                                device="cpu")
    cfg = rt.RenderConfig(rays_per_pixel=4, use_blur=False, use_denoiser=False)
    return InteractiveSession(dev, cfg)


@pytest.fixture(scope="module")
def viewer(tmp_path_factory):
    import os

    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("shots"))  # screenshots land in cwd
    v = HttpViewer(_session(), port=0).start()
    try:
        yield v
    finally:
        v.stop()
        os.chdir(cwd)
        assert not any(t.is_alive() for t in v._threads)


def _get(v, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}", timeout=TIMEOUT) as r:
        return r.read(), dict(r.headers)


def _post(v, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{v.port}/event", data=json.dumps(obj).encode(), method="POST",
    )
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.status == 204


def test_page_and_frame(viewer):
    body, headers = _get(viewer, "/")
    assert b"/stream" in body and "text/html" in headers["Content-Type"]
    jpg, headers = _get(viewer, "/frame.jpg")
    assert jpg[:2] == b"\xff\xd8"  # JPEG SOI
    assert headers["Content-Type"] == "image/jpeg"


def test_stream_delivers_distinct_frames(viewer):
    url = f"http://127.0.0.1:{viewer.port}/stream"
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
        raw = b""
        while raw.count(b"\xff\xd8") < 2:  # two JPEG starts = two frames
            chunk = r.read(4096)
            assert chunk, "stream ended early"
            raw += chunk
    assert raw.count(b"--frame") >= 2


def test_events_apply_session_semantics(viewer):
    s = viewer.session
    z0 = float(s.camera.zoom_factor)
    f0 = viewer.frames
    _post(viewer, {"type": "scroll", "y": 1.0})
    _post(viewer, {"type": "drag", "dx": 10.0, "dy": -4.0})
    viewer.wait_frame(after=f0 + 2, timeout=TIMEOUT)  # events apply before a next frame
    stats = json.loads(_get(viewer, "/stats")[0])
    z1 = stats["zoom"]
    assert z1 == pytest.approx(z0 / ZOOM_STEP)
    # drag: offset -= delta * zoom (glfw_events.cpp:122-123)
    assert stats["offset"][0] == pytest.approx(-10.0 * z1)
    assert stats["offset"][1] == pytest.approx(4.0 * z1)
    assert stats["fps"] > 0 and stats["frames"] > f0
    assert len(viewer.loop_times) > 0


def test_screenshot_roundtrip(viewer):
    f0 = viewer.frames
    _post(viewer, {"type": "screenshot"})
    viewer.wait_frame(after=f0 + 2, timeout=TIMEOUT)
    stats = json.loads(_get(viewer, "/stats")[0])
    assert stats["screenshot"], "screenshot path not recorded"
    from PIL import Image

    im = Image.open(stats["screenshot"])
    assert im.size == (viewer.session.scene.width, viewer.session.scene.height)


def test_render_error_surfaces_in_wait_frame():
    session = _session()

    def broken(block=True):
        raise ValueError("no frame")

    session.render = broken
    v = HttpViewer(session, port=0).start()
    try:
        with pytest.raises(RuntimeError, match="render loop died"):
            v.wait_frame(timeout=TIMEOUT)
    finally:
        v.stop()
    assert not any(t.is_alive() for t in v._threads)
