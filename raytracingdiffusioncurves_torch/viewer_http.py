"""Windowed display path: a zero-dependency MJPEG HTTP viewer.

The reference displays frames through a CUDA<->GL pixel-buffer interop and a
GLFW window (optixHello.cpp:120-151,1247-1249).  Here, as in the JAX
package, the display is a push over a socket: one render thread drives the
session's renderer flat out (the reference's render loop, :1163-1259), a
second thread encodes each frame as JPEG, and every connected browser
receives the frames as a multipart/x-mixed-replace stream (motion JPEG,
which every browser displays natively).  Zoom / pan / screenshot events
post back and are applied between frames with the ``InteractiveSession``
semantics (glfw_events.cpp:50-143).  A frame is quantized on its device
(``to_uint8_device``) and copied to the host once, as uint8.

Stdlib only (http.server + threading); PIL does the JPEG encode (the same
dependency the screenshot writer uses).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .utils.image import to_uint8_device

JPEG_QUALITY = 85

_PAGE = """<!doctype html>
<html><head><title>raytracingdiffusioncurves_torch</title><style>
  body { margin:0; background:#111; color:#ccc; font:12px monospace;
         display:flex; flex-direction:column; align-items:center }
  #v { max-width:100vw; max-height:94vh; cursor:grab }
  #bar { padding:4px }
</style></head><body>
<div id="bar">scroll = zoom &middot; drag = pan &middot; s / F11 =
screenshot &middot; <span id="st"></span></div>
<img id="v" src="/stream" draggable="false">
<script>
const v = document.getElementById("v");
const post = (o) => fetch("/event", {method: "POST",
                                     body: JSON.stringify(o)});
v.addEventListener("wheel", (e) => {
  e.preventDefault();
  post({type: "scroll", y: e.deltaY < 0 ? 1.0 : -1.0});
}, {passive: false});
let drag = null;
v.addEventListener("pointerdown", (e) => {
  drag = [e.clientX, e.clientY]; v.setPointerCapture(e.pointerId);
});
v.addEventListener("pointermove", (e) => {
  if (!drag) return;
  const s = v.naturalWidth / v.clientWidth;  // css px -> image px
  post({type: "drag", dx: (e.clientX - drag[0]) * s,
        dy: (e.clientY - drag[1]) * s});
  drag = [e.clientX, e.clientY];
});
v.addEventListener("pointerup", () => { drag = null; });
window.addEventListener("keydown", (e) => {
  if (e.key === "s" || e.key === "F11") {
    e.preventDefault(); post({type: "screenshot"});
  }
});
setInterval(async () => {
  const s = await (await fetch("/stats")).json();
  document.getElementById("st").textContent =
    `${s.fps.toFixed(1)} fps  zoom ${s.zoom.toFixed(3)}  ` +
    `frame ${s.frames}` + (s.screenshot ? `  saved ${s.screenshot}` : "");
}, 500);
</script></body></html>"""


class HttpViewer:
    """Serve an ``InteractiveSession`` as a live MJPEG page.

    One render thread owns the session and renders on its device; HTTP
    handler threads only read the latest encoded frame and enqueue events,
    which the render thread applies between frames: the same
    poll-events-then-render cadence as the reference loop.  An error in
    the render or encode thread surfaces in ``wait_frame``.
    """

    def __init__(self, session, host: str = "127.0.0.1", port: int = 0):
        self.session = session
        self.events: queue.Queue = queue.Queue()
        self.running = False
        self.frames = 0
        self.last_screenshot = None
        self._jpeg = None
        self._latest_arr = None  # newest host u8 frame for the encode loop
        self._cond = threading.Condition()
        self._render_err = None
        # seconds of each render-loop pass: events, enqueue, readback
        self.loop_times: list[float] = []
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame.jpg":
                    jpg = viewer.wait_frame()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpg)))
                    self.end_headers()
                    self.wfile.write(jpg)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    last = -1
                    try:
                        while viewer.running:
                            jpg, last = viewer.wait_frame(after=last)
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                            )
                            self.wfile.write(jpg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/stats":
                    s = viewer.session
                    ms = s.mean_frame_time_ms or 1e9
                    body = json.dumps({
                        "frames": viewer.frames,
                        "mean_frame_ms": ms,
                        "fps": 1000.0 / ms,
                        "zoom": float(s.camera.zoom_factor),
                        "offset": [float(s.camera.offset_x),
                                   float(s.camera.offset_y)],
                        "screenshot": viewer.last_screenshot,
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/event":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self.send_error(400)
                    return
                viewer.events.put(ev)
                self.send_response(204)
                self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        # a /stream handler waits for frames: stop() must not join it
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._threads: list[threading.Thread] = []

    # --- render side ---

    def _apply_events(self):
        while True:
            try:
                ev = self.events.get_nowait()
            except queue.Empty:
                return
            kind = ev.get("type")
            if kind == "scroll":
                self.session.scroll(float(ev.get("y", 0.0)))
            elif kind == "drag":
                self.session.drag(float(ev.get("dx", 0.0)),
                                  float(ev.get("dy", 0.0)))
            elif kind == "screenshot" and hasattr(self.session, "last_image"):
                self.last_screenshot = self.session.screenshot()

    def _readback_u8(self, image: torch.Tensor) -> np.ndarray:
        """Device image -> host (H, W, 3) uint8: quantized on the device,
        then one uint8 copy to the host (which waits for the frame)."""
        flip = self.session.config.diffusion_curve_save
        return to_uint8_device(image[..., :3], flip_vertical=flip).cpu().numpy()

    def _encode_jpeg(self, arr: np.ndarray) -> bytes:
        """Host uint8 array -> JPEG bytes (the host-only half)."""
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=JPEG_QUALITY)
        return buf.getvalue()

    def _render_loop(self):
        """Render + readback; JPEG encode runs in its own pipelined thread
        (_encode_loop), so stream fps is bounded by the slower stage, not
        their sum.  render(block=False): the uint8 readback waits for the
        frame, so the loop waits for the card once per frame."""
        try:
            device = self.session.device
            if device.type == "cuda":
                torch.cuda.set_device(device)  # the thread's current device
            while self.running:
                t0 = time.perf_counter()
                self._apply_events()
                img = self.session.render(block=False)
                arr = self._readback_u8(img)
                self.loop_times.append(time.perf_counter() - t0)
                with self._cond:
                    self._latest_arr = arr
                    self._cond.notify_all()
        except Exception as e:  # surface in wait_frame instead of dying mute
            self._render_err = e
            with self._cond:
                self._cond.notify_all()

    def _encode_loop(self):
        try:
            seen = None
            while self.running:
                with self._cond:
                    self._cond.wait_for(
                        lambda: (self._latest_arr is not None
                                 and self._latest_arr is not seen)
                        or not self.running,
                        timeout=1.0,
                    )
                    arr = self._latest_arr
                if arr is None or arr is seen:
                    continue
                seen = arr
                jpg = self._encode_jpeg(arr)
                with self._cond:
                    self._jpeg = jpg
                    self.frames += 1
                    self._cond.notify_all()
        except Exception as e:
            self._render_err = e
            with self._cond:
                self._cond.notify_all()

    def wait_frame(self, after: int | None = None, timeout: float = 120.0):
        """Block until a frame newer than ``after`` exists.  Returns the
        JPEG bytes (and the frame counter when ``after`` is given)."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._render_err is not None
                or (self._jpeg is not None
                    and (after is None or self.frames > after)),
                timeout=timeout,
            )
            if self._render_err is not None:
                raise RuntimeError("render loop died") from self._render_err
            if self._jpeg is None:
                raise TimeoutError("no frame rendered")
            return self._jpeg if after is None else (self._jpeg, self.frames)

    # --- lifecycle ---

    def start(self):
        self.running = True
        for target in (self._render_loop, self._encode_loop,
                       self.httpd.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self.running = False
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)

    def serve_forever(self):
        """Blocking variant for the CLI."""
        self.start()
        print(f"viewer: http://127.0.0.1:{self.port}/  (Ctrl-C to stop)",
              flush=True)
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
            ms = self.session.mean_frame_time_ms
            print(f"Average frame time : {ms:.2f}ms")
