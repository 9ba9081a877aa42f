"""Interactive viewing: the session state machine and an optional window.

``InteractiveSession`` is the headless core, the JAX package's session on
the port: the reference's GLFW event handlers (glfw_events.cpp:50-143)
driving the renderer.  Scroll zooms by 1.5^-ticks and writes the zoom flow
for the temporal denoiser (:105-112); drag pans by the mouse delta times
the zoom (:115-130) and writes the translation flow (the reference passes
zero deltas there; fixed, PARITY.md); ``screenshot`` is F11 (:50-100).

Acceleration tables, per frame:

* a **moving** frame (the camera changed since the last frame) selects its
  tables from the session's world grid (``trace_cuda.build_cand_grid``)
  with one gather, and rebuilds the grid only when it no longer serves the
  camera (``grid_serves``).  The grid is built one zoom-out step wide and
  over a viewport 1.5x the screen, so pans and zooms stay inside it, and
  serves one zoom-in step past the camera it was built for;
* a **resting** frame (the second one on a camera) builds the camera's own
  tight tables once (``build_cand_tables``, ``seg_max_count``,
  ``narrow_cand_tables``) and reuses them while the camera rests.

Camera values are launch arguments: no interaction rebuilds anything else.
``run_viewer`` wraps the session in a matplotlib window when a display is
available; the session itself needs none.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .config import Camera, RenderConfig
from .models import renderer
from .ops import flow as flow_ops
from .ops import trace_cuda
from .scene.device import DeviceScene
from .utils.image import save_image
from .utils.timing import span

ZOOM_STEP = 1.5  # glfw_events.cpp:39
# The world grid's margins: built for zooms up to one zoom-out step past
# the camera's, over this many screens around the view.
GRID_VIEWPORTS = 1.5
# The zooms a grid serves: zoom_max / GRID_ZOOM_RANGE <= zoom <= zoom_max,
# one step either way of the camera it was built for.  Deeper in, the
# cells (one tile at zoom_max) hold ever more segments per tile: on the
# dense-scene frame (NVIDIA H100 80GB HBM3, 700 W; the bring-up run that
# PERF.md's Findings record) a grid rebuilt two to four steps in takes
# 28-38 ms less per moving frame than the stale one, for one build of
# ~0.09 s.
GRID_ZOOM_RANGE = ZOOM_STEP**2


class InteractiveSession:
    """Drives the renderer with the zoom / pan / screenshot semantics of the
    reference viewer, on the scene's device.

    ``denoiser``: the module that holds a checkpoint's weights on the
    scene's device (``net_for_params(load_params(path))``), or None for the
    analytic temporal pass.  ``progressive``: accumulate fresh rays while
    the camera rests; a move resets the history."""

    def __init__(
        self,
        scene: DeviceScene,
        config: RenderConfig,
        camera: Camera = Camera(),
        progressive: bool = False,
        denoiser: torch.nn.Module | None = None,
    ):
        if denoiser is not None and not isinstance(denoiser, torch.nn.Module):
            raise TypeError(
                "denoiser: pass the module, net_for_params(load_params(path)), "
                "not the checkpoint tree"
            )
        self.scene = scene
        self.config = config
        self.camera = camera
        self.denoiser = denoiser
        self.device = scene.device
        self.state = renderer.init_frame_state(scene.width, scene.height, device=self.device)
        self.frame_times: list[float] = []
        self.progressive = progressive
        self.prog = (
            renderer.init_progressive_state(scene.width, scene.height, device=self.device)
            if progressive
            else None
        )
        self.last_image = None
        self._moved = True  # the first frame has no history
        # the resting camera's own tables, built on its second frame
        self._cand_tables = None
        self._cand_camera = None
        self._gather_len = None
        # the world grid that serves moving frames; its builds, for reports
        self.grid: trace_cuda.WorldGrid | None = None
        self.grid_builds = 0

    def scroll(self, yoffset: float) -> None:
        """Zoom: zoom_factor *= 1.5^-yoffset, with the radial flow update for
        the temporal denoiser (scroll_callback, glfw_events.cpp:105-112)."""
        with span("session.event.scroll", frame=self.state.frame):
            old = self.camera.zoom_factor
            new = old * ZOOM_STEP ** (-yoffset)
            flow = flow_ops.add_zoom_flow(self.state.flow, old, new)
            self.state = dataclasses.replace(self.state, flow=flow)
            self.camera = Camera(new, self.camera.offset_x, self.camera.offset_y)
            self._moved = True

    def drag(self, dx_pixels: float, dy_pixels: float) -> None:
        """Pan by a mouse delta in pixels: offset -= delta * zoom
        (mouse_cursor_callback, glfw_events.cpp:122-123) plus the translation
        flow the reference intended (:128)."""
        with span("session.event.drag", frame=self.state.frame):
            z = self.camera.zoom_factor
            self.camera = Camera(
                z, self.camera.offset_x - dx_pixels * z, self.camera.offset_y - dy_pixels * z
            )
            flow = flow_ops.add_translation_flow(self.state.flow, -dx_pixels, -dy_pixels)
            self.state = dataclasses.replace(self.state, flow=flow)
            self._moved = True

    def grid_serves(self) -> bool:
        """Whether the session's grid serves the current camera: it covers
        the camera (``grid_covers``) and the zoom is at most one step below
        the camera it was built for.  On the host; never waits for the card."""
        g = self.grid
        return (
            g is not None
            and float(self.camera.zoom_factor) >= g.zoom_max / GRID_ZOOM_RANGE * (1 - 1e-6)
            and trace_cuda.grid_covers(g, self.scene, self.camera, self.config)
        )

    def world_grid(self) -> trace_cuda.WorldGrid | None:
        """The session's world grid, (re)built around the current view with
        the zoom and pan margins when it no longer serves the camera."""
        if self.grid_serves():
            return self.grid
        z = float(self.camera.zoom_factor) * ZOOM_STEP  # one zoom-out step
        cx, cy = float(self.camera.offset_x), float(self.camera.offset_y)
        hx = GRID_VIEWPORTS * 0.5 * self.scene.width * z
        hy = GRID_VIEWPORTS * 0.5 * self.scene.height * z
        self.grid = None  # free the old grid's tables before the new build
        with span("session.grid_build", frame=self.state.frame):
            self.grid = trace_cuda.build_cand_grid(
                self.scene, self.config, cx - hx, cy - hy, cx + hx, cy + hy, zoom_max=z
            )
        self.grid_builds += 1
        return self.grid

    def accel_tables(self):
        """(tables, gather_len) for this frame's camera: selected from the
        world grid on a moving frame, the camera's own (built once) on a
        resting one.  (None, None) for scenes that take the full sweep."""
        f = self.state.frame
        with span("session.accel", frame=f):
            if self.camera == self._cand_camera:
                if self._cand_tables is None:
                    with span("session.own_tables", frame=f):
                        self._cand_tables = trace_cuda.build_cand_tables(
                            self.scene, self.camera, self.config
                        )
                        self._gather_len = trace_cuda.seg_max_count(
                            self.scene, self._cand_tables)
                        if self._gather_len is not None:
                            self._cand_tables = trace_cuda.narrow_cand_tables(
                                self._cand_tables, self._gather_len
                            )
                return self._cand_tables, self._gather_len
            # the camera changed this frame
            self._cand_camera = self.camera
            self._cand_tables = self._gather_len = None
            grid = self.world_grid()
            if grid is None:
                return None, None
            with span("session.grid_gather", frame=f):
                return (
                    trace_cuda.grid_tables(grid, self.scene, self.camera, self.config),
                    grid.gather_len,
                )

    def render(self, block: bool = True) -> torch.Tensor:
        """Render one frame; returns the (H, W, 4) image on the scene's
        device.  The frame time follows the reference's protocol
        (optixHello.cpp:1258-1263).  ``block=False`` enqueues the frame
        without waiting for the card: frame_times then record the enqueue,
        and a display loop gets its synchronization from its readback."""
        t0 = time.perf_counter()
        with span("session.render", frame=self.state.frame):
            cand_tables, gather_len = self.accel_tables()
            kw = dict(denoiser=self.denoiser, cand_tables=cand_tables, gather_len=gather_len)
            if self.progressive:
                image, self.state, self.prog = renderer.render_frame_progressive(
                    self.scene, self.camera, self.state, self.prog, self.config, self._moved,
                    **kw
                )
            else:
                image, self.state = renderer.render_frame(
                    self.scene, self.camera, self.state, self.config, **kw
                )
            self._moved = False
            if block and self.device.type == "cuda":
                with span("sync.render_block"):
                    torch.cuda.synchronize(self.device)
        self.frame_times.append(time.perf_counter() - t0)
        self.last_image = image
        return image

    def screenshot(self, path: str | None = None) -> str:
        """F11 equivalent (key_callback, glfw_events.cpp:50-100)."""
        return save_image(
            self.last_image, path, flip_vertical=self.config.diffusion_curve_save
        )

    @property
    def mean_frame_time_ms(self) -> float:
        if not self.frame_times:
            return 0.0
        return 1000.0 * sum(self.frame_times) / len(self.frame_times)


def run_viewer(
    scene: DeviceScene,
    config: RenderConfig,
    camera: Camera = Camera(),
    denoiser: torch.nn.Module | None = None,
):
    """Open a matplotlib window with scroll-zoom, drag-pan and 's'
    screenshot.  Without a display it prints why and returns the session."""
    session = InteractiveSession(scene, config, camera, denoiser=denoiser)
    try:
        import matplotlib

        if not matplotlib.get_backend().lower().startswith(("qt", "tk", "gtk", "macosx", "wx")):
            matplotlib.use("TkAgg")
        import matplotlib.pyplot as plt
    except Exception as exc:  # headless environment: report, keep the session
        print(f"viewer: no interactive display available ({exc}); "
              "use InteractiveSession programmatically instead")
        return session

    def frame_rgb():
        a = session.render()[..., :3].cpu().numpy()
        if config.diffusion_curve_save:
            a = a[::-1]
        return np.clip(a, 0, 1)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_axis_off()
    im = ax.imshow(frame_rgb())
    dragging = {"on": False, "x": 0.0, "y": 0.0}

    def refresh():
        im.set_data(frame_rgb())
        fig.canvas.draw_idle()

    def on_scroll(event):
        session.scroll(1.0 if event.button == "up" else -1.0)
        refresh()

    def on_press(event):
        dragging.update(on=True, x=event.x, y=event.y)

    def on_release(event):
        dragging["on"] = False

    def on_move(event):
        if dragging["on"]:
            session.drag(event.x - dragging["x"], event.y - dragging["y"])
            dragging.update(x=event.x, y=event.y)
            refresh()

    def on_key(event):
        if event.key in ("s", "f11"):
            print("saved", session.screenshot())

    fig.canvas.mpl_connect("scroll_event", on_scroll)
    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show()
    print(f"Average frame time : {session.mean_frame_time_ms:.2f}ms")
    return session
