"""Multi-device rendering: data-parallel over row bands of the image.

The reference is strictly single-GPU (SURVEY.md section 2.4): its only
parallelism is one CUDA thread per pixel.  The JAX package shards the pixel
grid over a device mesh's ``rows`` axis with ``shard_map``; this module is
its counterpart in ``torch.distributed``, one process (rank) per device:

* the H x W pixel grid is cut into contiguous row bands, band i on rank i
  (``px_start = rank * rows_local * W``); the scene tables are small and
  every rank holds them whole;
* the trace needs no communication: each rank runs the trace kernel on its
  own band (``trace_cuda.trace_sums_flat``), and because the RNG is keyed on
  the global ray id the band's sums are bitwise those of a one-device frame;
* the camera-dependent acceleration tables are built per band
  (``build_cand_tables_sharded``); ``seg_max_count_sharded`` takes the
  slot-mode lists' certified length as the max over ranks, so every rank
  narrows alike;
* post-processing (the denoiser and the variable blur, whose windows cross
  band edges) is the one-device tail, ``renderer._postprocess``, run on the
  band with this module's hooks: each filter reads the band plus the rows
  of the frame its window reaches (its halo: the blur's radius, the
  bilateral's 2, the UNet's receptive field plus 2 rounded to a multiple of
  4, ``denoiser.band_halo``), which the neighbours send as fixed-size edge
  strips (``_with_halo``, one ``all_gather``), with none past the frame's
  top and bottom, where each filter pads as on the whole frame.  The
  denoiser's region is widened to start and end on a multiple of 4 rows of
  the frame, so the UNet's stride-2 grids are the whole frame's on a band
  of any height.  So every value is bitwise the one-device tail's.  The
  JAX package gets the same from XLA's halo exchanges on the row-sharded
  image;
* the result and the ``FrameState`` stay row-sharded: each rank holds its
  band of the image, the history and the flow (``frame_state_sharded``);
  the history is gathered only on frames whose flow is non-zero, whose warp
  reads source rows from the whole frame.  ``gather_rows`` and
  ``gather_frame_state`` assemble the whole frame for display and IO.

``make_mesh`` wraps the process group as a 1-D ``DeviceMesh`` named
``rows``.  Every rank calls each function of this module with the same
arguments (they hold collectives).  The collective backend is the caller's
explicit choice (``spawn_ranks(backend=)``): NCCL when each rank has its own
card, gloo on the CPU or for ranks that share one card; the exchanges are
all_gathers, which both take on CUDA tensors.  The data-parallel denoiser
train step is ``models.denoiser.train_step(group=group(mesh))``, each rank
passing its shard of the batch.
"""

from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import Camera, RenderConfig
from ..models import renderer
from ..ops import flow as flow_ops
from ..ops import trace_cuda
from ..scene.device import DeviceScene
from ..utils.timing import span

# What this rank's collectives moved since its last frame began (each frame
# function clears it first), in order: ("halo", bytes received, rows of the
# band + halo region built) for each edge-strip exchange, ("gather", bytes
# received, rows) for each whole-frame all_gather.  chip_smoke.py and the
# tests read it to show what a frame moves and which rows its
# post-processing read.
EXCHANGE_LOG: list[tuple[str, int, int]] = []


def make_mesh(n_devices: int | None = None, axis_name: str = "rows",
              device_type: str = "cuda") -> DeviceMesh:
    """1-D device mesh over the band axis: the initialised default process
    group, one rank per device.  ``n_devices`` (None = the world size) must
    be the world size: another count raises, as the JAX package's does for
    more devices than it has."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"requested {n} devices, have {world} ranks")
    return DeviceMesh.from_group(dist.group.WORLD, device_type, mesh_dim_names=(axis_name,))


def _local_rows(mesh: DeviceMesh, height: int) -> int:
    """Rows of each band: the height over the mesh size, which must divide
    it."""
    n = mesh.size()
    if height % n != 0:
        raise ValueError(f"image height {height} not divisible by mesh size {n}")
    return height // n


def _band(mesh: DeviceMesh, scene: DeviceScene) -> tuple[int, int]:
    """(first pixel, pixel count) of this rank's band."""
    n_px = _local_rows(mesh, scene.height) * scene.width
    return mesh.get_local_rank() * n_px, n_px


def group(mesh: DeviceMesh):
    """The mesh's process group: ``models.denoiser.train_step(group=)``
    averages the gradients of a data-parallel step over it."""
    (axis_name,) = mesh.mesh_dim_names
    return mesh.get_group(axis_name)


def build_cand_tables_sharded(mesh: DeviceMesh, scene: DeviceScene, camera: Camera,
                              config: RenderConfig):
    """This rank's camera-dependent acceleration tables: those of its own
    row band (the ``px_start`` the sharded trace uses), so passing them to
    ``trace_image_sharded``/``render_frame_sharded`` hoists the per-frame
    prepass like the one-device ``build_cand_tables``.  Every band takes the
    full frame's wedge shift (``trace_cuda.table_layout``), so all ranks'
    tables share one structure.  None for scenes that take the full sweep."""
    px_start, n_px = _band(mesh, scene)
    return trace_cuda.build_cand_tables(scene, camera, config, px_start=px_start, n_px=n_px)


def seg_max_count_sharded(mesh: DeviceMesh, scene: DeviceScene, cand_tables) -> int | None:
    """``seg_max_count`` over every rank's tables (an all_reduce MAX), so
    every rank narrows its lists to one length; None where the tables are not
    slot-mode lists (the same on every rank: the kind depends on the scene,
    the config and the band size alone, the wedge shift on the full frame)."""
    local = trace_cuda.seg_max_count(scene, cand_tables)
    if local is None:
        return None
    count = torch.tensor([local], dtype=torch.int64, device=scene.device)
    dist.all_reduce(count, op=dist.ReduceOp.MAX, group=group(mesh))
    return int(count.item())


def trace_sums_sharded(mesh: DeviceMesh, scene: DeviceScene, camera: Camera,
                       config: RenderConfig, frame: int = 0, cand_tables=None,
                       gather_len: int | None = None):
    """Raw trace sums of this rank's row band: (color_sum (rows, W, 3),
    weight_sum (rows, W), blur_sum (rows, W)), bitwise the same rows of the
    one-device sums.  ``cand_tables``: ``build_cand_tables_sharded`` output
    for THIS camera (None builds the band's tables in-frame, as trace_image
    does); ``gather_len``: ``seg_max_count_sharded``'s value."""
    rows = _local_rows(mesh, scene.height)
    w = scene.width
    px_start, n_px = _band(mesh, scene)
    if cand_tables is None:
        cand_tables = trace_cuda.build_cand_tables(scene, camera, config, px_start, n_px)
    csum, wsum, bsum = trace_cuda.trace_sums_flat(
        scene, camera, config, frame, px_start, n_px, cand_tables, gather_len)
    return csum.reshape(rows, w, 3), wsum.reshape(rows, w), bsum.reshape(rows, w)


def trace_image_sharded(mesh: DeviceMesh, scene: DeviceScene, camera: Camera,
                        config: RenderConfig, frame: int = 0, cand_tables=None,
                        gather_len: int | None = None):
    """Trace this rank's row band: (image (rows, W, 4), blur_map (rows, W))."""
    with span("trace", frame=frame):
        sums = trace_sums_sharded(mesh, scene, camera, config, frame, cand_tables, gather_len)
        return renderer.normalize_sums(*sums, config)


def _all_gather(mesh: DeviceMesh, t: torch.Tensor, kind: str, rows: int) -> list[torch.Tensor]:
    """Every rank's ``t`` (the same shape on all), logged in EXCHANGE_LOG."""
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(parts, t.contiguous(), group=group(mesh))
    EXCHANGE_LOG.append((kind, mesh.size() * t.numel() * t.element_size(), rows))
    return parts


def gather_rows(mesh: DeviceMesh, band: torch.Tensor) -> torch.Tensor:
    """The whole frame from every rank's row band (an all_gather, on every
    rank), for display and IO."""
    return torch.cat(_all_gather(mesh, band, "gather", band.shape[0] * mesh.size()), dim=0)


def _halo_rows(rank: int, rows: int, height: int, halo: int, align: int) -> tuple[int, int]:
    """(rows above, rows below) of band ``rank``'s region: at least ``halo``
    on each side, cut at the frame's edges, the region's first and last
    rows on a multiple of ``align`` rows of the frame (or at its edge)."""
    r0, r1 = rank * rows, rank * rows + rows
    start = max(0, (r0 - halo) // align * align)
    end = min(height, -(-(r1 + halo) // align) * align)
    return r0 - start, end - r1


def _with_halo(mesh: DeviceMesh, bands: list[torch.Tensor], halo: int, align: int = 1):
    """This rank's bands (rows, ...) of some frames, each with the rows of
    its frame that ``_halo_rows`` gives on each side: (regions, rows above,
    rows below); the tail's ``exchange`` hook.  One all_gather of
    fixed-size edge strips, the tensors' channels side by side: every rank
    sends its first and last k rows, k the widest side of any rank's region
    (at most its band), n x 2k rows in all (NCCL and gloo alike: gloo has
    no send/recv on CUDA tensors); a halo wider than a band takes rows from
    further ranks, whose strips are then their whole bands."""
    n, rank, rows = mesh.size(), mesh.get_local_rank(), bands[0].shape[0]
    sides = [_halo_rows(j, rows, n * rows, halo, align) for j in range(n)]
    k = min(max(max(side) for side in sides), rows)
    cols = [b.reshape(rows, b.shape[1], -1) for b in bands]
    strip = torch.cat([torch.cat([c[:k], c[rows - k :]]) for c in cols], dim=-1)
    top, bottom = sides[rank]
    parts = _all_gather(mesh, strip, "halo", top + rows + bottom)
    above, below = [], []
    for j in range(rank - 1, -1, -1):  # the last rows of the bands above
        m = min(top - (rank - 1 - j) * rows, rows)
        if m <= 0:
            break
        above.insert(0, parts[j][2 * k - m :])
    for j in range(rank + 1, n):  # the first rows of the bands below
        m = min(bottom - (j - rank - 1) * rows, rows)
        if m <= 0:
            break
        below.append(parts[j][:m])
    regions, c0 = [], 0
    for band, c in zip(bands, cols):
        c1 = c0 + c.shape[-1]
        pieces = [p[..., c0:c1] for p in above] + [c] + [p[..., c0:c1] for p in below]
        regions.append(torch.cat(pieces).reshape((-1,) + band.shape[1:]))
        c0 = c1
    return regions, top, bottom


def _warp_band(mesh: DeviceMesh, state: renderer.FrameState) -> torch.Tensor:
    """This rank's band of ``warp_separable(whole history, whole flow)``;
    the tail's ``warp`` hook.  The row product reads source rows from
    anywhere in the frame (a zoom moves rows across bands), so the history
    and the flow's row profile are gathered; the column profile is any
    row's, the band's first.  The whole frame is warped and the band kept:
    the band's slice of the row product alone is a matrix product of another
    shape, which cuBLAS rounds differently (not bitwise on the card)."""
    rows = state.prev_image.shape[0]
    history = gather_rows(mesh, state.prev_image)
    flow_y = gather_rows(mesh, state.flow[:, 0, 1])
    r0 = mesh.get_local_rank() * rows
    return flow_ops.warp_separable_profiles(history, state.flow[0, :, 0], flow_y)[r0 : r0 + rows]


def band_hooks(mesh: DeviceMesh) -> dict:
    """The hooks that run ``renderer._postprocess`` on this rank's band:
    ``exchange`` (``_with_halo``) and ``warp`` (``_warp_band``)."""
    def exchange(bands, halo, align=1):
        with span("post.exchange"):
            return _with_halo(mesh, bands, halo, align)

    return {"exchange": exchange, "warp": lambda state: _warp_band(mesh, state)}


def frame_state_sharded(mesh: DeviceMesh, state: renderer.FrameState) -> renderer.FrameState:
    """This rank's band of a whole frame's FrameState (``init_frame_state``
    for a first frame, ``load_session``'s on resume): the band's rows of the
    history and the flow, copied, with the flow still known to be zero where
    it was.  What ``render_frame_sharded`` takes and returns."""
    h = state.prev_image.shape[0]
    rows = _local_rows(mesh, h)
    r0 = mesh.get_local_rank() * rows
    zero = None if state.zero_flow is None else state.zero_flow[r0 : r0 + rows].clone()
    flow = zero if state.flow_is_zero else state.flow[r0 : r0 + rows].clone()
    return renderer.FrameState(prev_image=state.prev_image[r0 : r0 + rows].clone(), flow=flow,
                               frame=state.frame, zero_flow=zero)


def gather_frame_state(mesh: DeviceMesh, state: renderer.FrameState) -> renderer.FrameState:
    """The whole frame's FrameState from every rank's band (all_gathers, on
    every rank): for IO such as ``save_session``, whose file holds the whole
    frame."""
    flow = gather_rows(mesh, state.flow)
    return renderer.FrameState(prev_image=gather_rows(mesh, state.prev_image), flow=flow,
                               frame=state.frame,
                               zero_flow=flow if state.flow_is_zero else None)


def add_zoom_flow_sharded(mesh: DeviceMesh, flow: torch.Tensor, old_zoom: float,
                          new_zoom: float) -> torch.Tensor:
    """``add_zoom_flow`` on this rank's band of the flow: its rows of the
    whole frame's radial field."""
    rows = flow.shape[0]
    return flow_ops.add_zoom_flow(flow, old_zoom, new_zoom, row0=mesh.get_local_rank() * rows,
                                  height=rows * mesh.size())


def _check_band_state(mesh: DeviceMesh, scene: DeviceScene, state: renderer.FrameState):
    rows = _local_rows(mesh, scene.height)
    if state.prev_image.shape[:2] != (rows, scene.width):
        raise ValueError(f"state holds {tuple(state.prev_image.shape[:2])} pixels, not this "
                         f"rank's band of {rows} x {scene.width}: pass frame_state_sharded's")


def render_frame_sharded(mesh: DeviceMesh, scene: DeviceScene, camera: Camera,
                         state: renderer.FrameState, config: RenderConfig,
                         max_blur_radius: int | None = None, denoiser=None,
                         cand_tables=None, gather_len: int | None = None):
    """Full multi-device frame: the band's trace, then the denoise + blur
    tail of ``renderer.render_frame`` on the band and its halos.  ``state``
    is this rank's band of the FrameState (``frame_state_sharded``); returns
    (this rank's band of the image, its band of the next FrameState),
    bitwise the band's rows of ``render_frame``'s.  ``denoiser``: the module
    with the checkpoint's weights on this rank's device, or None for the
    analytic pass.  A resting frame moves only edge strips between ranks; a
    frame after a camera move also gathers the history for the warp."""
    _check_band_state(mesh, scene, state)
    EXCHANGE_LOG.clear()
    with span("frame", frame=state.frame):
        image, blur_map = trace_image_sharded(mesh, scene, camera, config, state.frame,
                                              cand_tables, gather_len)
        image, next_prev = renderer._postprocess(image, blur_map, state, config, scene,
                                                 max_blur_radius, denoiser, **band_hooks(mesh))
        return image, renderer._next_state(state, next_prev, config)


def render_frame_progressive_sharded(mesh: DeviceMesh, scene: DeviceScene, camera: Camera,
                                     state: renderer.FrameState,
                                     prog: renderer.ProgressiveState, config: RenderConfig,
                                     reset: bool, max_blur_radius: int | None = None,
                                     denoiser=None, cand_tables=None,
                                     gather_len: int | None = None):
    """Multi-device progressive pass (``renderer.render_frame_progressive``):
    the band's fresh sums are added to ``prog``, this rank's band of the
    accumulator (``init_progressive_state(W, H // mesh.size())``), unless
    ``reset``; the accumulated band is normalized and post-processed as in
    ``render_frame_sharded``.  Returns (band image, band's next FrameState,
    next band ProgressiveState)."""
    _check_band_state(mesh, scene, state)
    EXCHANGE_LOG.clear()
    with span("frame", frame=state.frame):
        with span("trace", frame=state.frame):
            sums = trace_sums_sharded(mesh, scene, camera, config, state.frame, cand_tables,
                                      gather_len)
            next_prog = renderer._accumulate(sums, prog, reset)
            image, blur_map = renderer.normalize_sums(
                next_prog.color_sum, next_prog.weight_sum, next_prog.blur_sum, config)
        image, next_prev = renderer._postprocess(image, blur_map, state, config, scene,
                                                 max_blur_radius, denoiser, **band_hooks(mesh))
        return image, renderer._next_state(state, next_prev, config), next_prog


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, backend, args, results, timeout, threads):
    """One spawned rank: join the process group, run fn, report its value or
    its traceback on ``results`` (before leaving the group, so a failure is
    reported ahead of the errors it causes on the other ranks).  The ranks
    share the caller's CPU threads: each takes ``threads`` of them."""
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world_size, rank=rank,
            timeout=None if timeout is None else datetime.timedelta(seconds=timeout))
        try:
            value = fn(rank, world_size, *args)
        except Exception:  # the rank's boundary: the parent raises it
            results.put((rank, False, traceback.format_exc()))
            raise SystemExit(1)
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def spawn_ranks(fn, world_size: int, args: tuple = (), *, backend: str,
                timeout: float | None = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each a rank of a process group of ``backend`` ("nccl":
    one card per rank, "gloo": CPU tensors, or CUDA tensors of ranks that
    share a card) at a free localhost port.  ``fn`` must be importable
    (module level) and return picklable host data.  Returns the values by
    rank.  Raises RuntimeError with the traceback of a rank that raised, and
    after ``timeout`` seconds (None: no limit; it is also the process
    group's timeout).  Every rank has ended when it returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    threads = max(1, torch.get_num_threads() // world_size)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, port, backend, args, results, timeout,
                               threads))
             for rank in range(world_size)]
    deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
    values, errors = {}, {}
    silent_since = None
    try:
        for p in procs:
            p.start()
        while len(values) < world_size and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks did not finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in values]
                if not dead:
                    continue
                # a rank's last message may still be in the pipe: allow 2 s
                silent_since = silent_since or time.monotonic()
                if time.monotonic() - silent_since > 2.0:
                    codes = {r: procs[r].exitcode for r in dead}
                    raise RuntimeError(f"ranks exited without a result: exit codes {codes}")
                continue
            (values if ok else errors)[rank] = value
        # a failure ends the others' collectives: collect their reports too
        while errors and len(values) + len(errors) < world_size:
            try:
                rank, ok, value = results.get(timeout=2.0)
            except queue.Empty:
                break
            (values if ok else errors)[rank] = value
    finally:
        # ranks that reported end by themselves; any other may hang in a
        # collective and is killed
        grace = 10.0 if len(values) == world_size else 1.0
        for p in procs:
            if p.pid is None:
                continue
            p.join(timeout=grace)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(f"rank {r} of {world_size} failed:\n{tb}"
                                     for r, tb in errors.items()))
    return [values[r] for r in range(world_size)]
