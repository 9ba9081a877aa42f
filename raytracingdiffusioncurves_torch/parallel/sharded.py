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
  band edges) runs the shared ``renderer._postprocess`` on the whole frame:
  each rank gathers the band images and blur maps (``all_gather``) and
  repeats it, then returns its own band.  The result is bitwise that of one
  device; the cost (the post-processing repeated on every rank) is where a
  halo exchange of the filters' radius would go.  The JAX package instead
  post-processes the row-sharded image through XLA's halo exchange.

``make_mesh`` wraps the process group as a 1-D ``DeviceMesh`` named
``rows``.  Every rank calls each function of this module with the same
arguments (they hold collectives).  The collective backend is the caller's
explicit choice (``spawn_ranks(backend=)``): NCCL when each rank has its own
card, gloo on the CPU or for ranks that share one card.  ``gather_rows``
assembles a band-sharded tensor for display or IO.  The data-parallel
denoiser train step is ``models.denoiser.train_step(group=group(mesh))``,
each rank passing its shard of the batch.
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
from ..ops import trace_cuda
from ..scene.device import DeviceScene


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


def _local_rows(mesh: DeviceMesh, scene: DeviceScene) -> int:
    h = scene.height
    n = mesh.size()
    if h % n != 0:
        raise ValueError(f"image height {h} not divisible by mesh size {n}")
    return h // n


def _band(mesh: DeviceMesh, scene: DeviceScene) -> tuple[int, int]:
    """(first pixel, pixel count) of this rank's band."""
    n_px = _local_rows(mesh, scene) * scene.width
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
    rows = _local_rows(mesh, scene)
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
    sums = trace_sums_sharded(mesh, scene, camera, config, frame, cand_tables, gather_len)
    return renderer.normalize_sums(*sums, config)


def gather_rows(mesh: DeviceMesh, band: torch.Tensor) -> torch.Tensor:
    """The whole frame from every rank's row band (an all_gather, on every
    rank), for display and IO."""
    parts = [torch.empty_like(band) for _ in range(mesh.size())]
    dist.all_gather(parts, band.contiguous(), group=group(mesh))
    return torch.cat(parts, dim=0)


def _band_of(mesh: DeviceMesh, image: torch.Tensor) -> torch.Tensor:
    rows = image.shape[0] // mesh.size()
    r0 = mesh.get_local_rank() * rows
    return image[r0 : r0 + rows]


def _postprocess_sharded(mesh, image, blur_map, state, config, scene, max_blur_radius,
                         denoiser):
    """The band's image and blur map gathered, the one-device tail on the
    whole frame, this rank's band of the result; returns (band image, next
    replicated FrameState)."""
    image = gather_rows(mesh, image)
    blur_map = gather_rows(mesh, blur_map)
    image, next_prev = renderer._postprocess(
        image, blur_map, state, config, scene, max_blur_radius, denoiser)
    return _band_of(mesh, image), renderer._next_state(state, next_prev, config)


def render_frame_sharded(mesh: DeviceMesh, scene: DeviceScene, camera: Camera,
                         state: renderer.FrameState, config: RenderConfig,
                         max_blur_radius: int | None = None, denoiser=None,
                         cand_tables=None, gather_len: int | None = None):
    """Full multi-device frame: the band's trace, then the denoise + blur
    tail of ``renderer.render_frame`` on the gathered frame.  ``state`` is
    the whole frame's FrameState (the same on every rank); returns (this
    rank's band of the image, the next FrameState, replicated), bitwise the
    band and state of ``render_frame``.  ``denoiser``: the module with the
    checkpoint's weights on this rank's device, or None for the analytic
    pass."""
    image, blur_map = trace_image_sharded(mesh, scene, camera, config, state.frame,
                                          cand_tables, gather_len)
    return _postprocess_sharded(mesh, image, blur_map, state, config, scene,
                                max_blur_radius, denoiser)


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
    ``render_frame_sharded``.  Returns (band image, next FrameState, next
    band ProgressiveState)."""
    sums = trace_sums_sharded(mesh, scene, camera, config, state.frame, cand_tables, gather_len)
    next_prog = renderer._accumulate(sums, prog, reset)
    image, blur_map = renderer.normalize_sums(
        next_prog.color_sum, next_prog.weight_sum, next_prog.blur_sum, config)
    image, next_state = _postprocess_sharded(mesh, image, blur_map, state, config, scene,
                                             max_blur_radius, denoiser)
    return image, next_state, next_prog


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
