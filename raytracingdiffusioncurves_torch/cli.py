"""Command-line renderer.

Mirrors the reference invocation ``OptixHello.exe <scene.xml> <rays_per_pixel>``
(README.md:10-13, optixHello.cpp:82-102) and its measurement protocol: setup
time printed once, mean frame time printed at exit
(optixHello.cpp:1156-1157,1260-1263).  The flags are the JAX package's CLI's,
with ``--device auto|cpu`` in place of its ``--backend``/``--device``:
``auto`` renders on the CUDA card and fails without one.

    python -m raytracingdiffusioncurves_torch <scene.xml> <rays_per_pixel>
        [--frames N] [--out image.png] [--width W --height H]
        [--no-blur] [--no-denoiser] [--no-aa] [--zoom Z --offset-x X --offset-y Y]
        [--device auto|cpu] [--devices N] [--viewer | --http-viewer PORT] [--stats]

``--devices N`` (N > 1) renders the frame in N row bands, one spawned rank
per device (``parallel/sharded.py``): rank i on ``cuda:i`` with NCCL, or N
gloo ranks on the CPU with ``--device cpu``.  Each rank keeps its band of
the frame state; rank 0 prints and writes the image, and ``--save-session``
writes the whole frame's history, gathered from the bands.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracingdiffusioncurves_torch",
        description="Diffusion-curve renderer on an NVIDIA GPU (PyTorch + CUDA)",
    )
    p.add_argument("scene", help="path to a diffusion curve xml")
    p.add_argument("rays", type=int, help="number of rays per pixel")
    p.add_argument("--frames", type=int, default=1, help="frames to render")
    p.add_argument("--out", default=None, help="output image path (png/jpg)")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--height", type=int, default=None, help="override image height")
    p.add_argument("--no-blur", action="store_true")
    p.add_argument("--no-denoiser", action="store_true")
    p.add_argument("--denoiser-weights", default=None, metavar="MSGPACK",
                   help="trained CNN denoiser weights; replaces the analytic "
                   "temporal denoiser.  Default: the shipped UNet, "
                   "weights/denoiser_r3d.msgpack; 'none' forces the analytic pass")
    p.add_argument("--no-aa", action="store_true")
    p.add_argument("--no-diffusion-save", action="store_true")
    p.add_argument("--zoom", type=float, default=1.0)
    p.add_argument("--offset-x", type=float, default=0.0)
    p.add_argument("--offset-y", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flatten-k", type=int, default=16)
    p.add_argument("--min-sub", type=int, default=None,
                   help="per-segment subdivision floor for adaptive flattening")
    p.add_argument("--sagitta", type=float, default=None,
                   help="max chord deviation (world units) for adaptive "
                   "flattening (0.25 by default)")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="auto: the CUDA card (an error without one); cpu: the "
                   "plain PyTorch version of every kernel")
    p.add_argument("--viewer", action="store_true", help="open the interactive viewer")
    p.add_argument("--http-viewer", type=int, default=None, metavar="PORT",
                   help="serve the live MJPEG viewer on this port (0 = auto)")
    p.add_argument("--devices", type=int, default=0,
                   help="render in row bands across N devices, one rank each (0 = single)")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the timed frames")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume temporal state + camera from a session checkpoint")
    p.add_argument("--save-session", default=None, metavar="CKPT",
                   help="write the session checkpoint on exit")
    p.add_argument("--stats", action="store_true",
                   help="print per-phase timing + metrics JSON lines on exit")
    return p


def shipped_weights() -> str | None:
    """The shipped UNet checkpoint, ``weights/denoiser_r3d.msgpack``, chosen
    by name (the other shipped file, ``denoiser.msgpack``, is the smaller
    CNN), or None where the checkout has no weights."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "weights", "denoiser_r3d.msgpack")
    return path if os.path.exists(path) else None


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.devices > 1:
        if args.viewer or args.http_viewer is not None or args.profile:
            parser.error("--viewer, --http-viewer and --profile run on one device, not --devices")
        return _render_sharded(args)

    from .utils.devices import resolve_device

    return _render(args, resolve_device("cpu" if args.device == "cpu" else "cuda"))


def _render_sharded(args) -> int:
    """--devices N: N spawned ranks, NCCL across N cards or gloo on the CPU."""
    import torch

    from .parallel import sharded
    from .utils.devices import resolve_device

    if args.device == "cpu":
        backend = "gloo"
    else:
        resolve_device("cuda")
        have = torch.cuda.device_count()
        if args.devices > have:
            raise ValueError(f"requested {args.devices} devices, have {have}")
        backend = "nccl"
    sharded.spawn_ranks(_rank, args.devices, (args,), backend=backend, timeout=None)
    return 0


def _rank(rank: int, world_size: int, args) -> int:
    """One rank of --devices: its device, the mesh, the render."""
    import torch

    from .parallel import sharded

    device = torch.device("cpu") if args.device == "cpu" else torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return _render(args, device, sharded.make_mesh(world_size, device_type=device.type))


def _render(args, device, mesh=None) -> int:
    """The CLI's render on ``device``; with ``mesh`` this rank's part of the
    row-band render (every rank runs it, rank 0 prints and writes)."""
    import torch

    from . import (
        Camera,
        RenderConfig,
        build_device_scene,
        init_frame_state,
        load_params,
        load_scene,
        net_for_params,
        render_frame,
        save_image,
    )
    from .ops import trace_cuda
    from .parallel import sharded
    from .utils.timing import Metrics, PhaseTimer

    lead = mesh is None or mesh.get_local_rank() == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timer = PhaseTimer()
    metrics = Metrics()

    setup_start = time.perf_counter()
    with timer.phase("scene_load"):
        scene = load_scene(args.scene, diffusion_curve_save=not args.no_diffusion_save)
        if args.width or args.height:
            scene = scene.with_size(args.width or scene.width, args.height or scene.height)
    with timer.phase("device_build"):
        dev = build_device_scene(scene, flatten_subdivisions=args.flatten_k,
                                 min_subdivisions=args.min_sub, device=device,
                                 **({"max_sagitta": args.sagitta} if args.sagitta else {}))
    metrics.set("n_segments", dev.s_pad)
    metrics.set("width", scene.width)
    metrics.set("height", scene.height)
    config = RenderConfig(
        rays_per_pixel=args.rays,
        diffusion_curve_save=not args.no_diffusion_save,
        use_blur=not args.no_blur,
        use_aa=not args.no_aa,
        use_denoiser=not args.no_denoiser,
        seed=args.seed,
    )
    camera = Camera(args.zoom, args.offset_x, args.offset_y)
    state = init_frame_state(scene.width, scene.height, device=device)
    if args.resume:
        from .utils.checkpoint import load_session

        state, camera, _ = load_session(args.resume, device=device)
        say(f"resumed at frame {state.frame} from {args.resume}")
    if mesh is not None:
        state = sharded.frame_state_sharded(mesh, state)  # this rank's band

    # The learned denoiser, built once: an explicit path wins; by default the
    # shipped UNet, so `use_denoiser` means the trained model out
    # of the box (the reference's pretrained OptiX model needs no flag either,
    # optixHello.cpp:1057); "none" forces the analytic pass.
    denoiser = None
    if not args.no_denoiser and args.denoiser_weights != "none":
        path = args.denoiser_weights
        if path in (None, "auto"):
            path = shipped_weights()
        if path is not None:
            denoiser = net_for_params(load_params(path), device=device)

    # The camera's acceleration tables, hoisted (the one-time accel build,
    # optixHello.cpp:764-830): the CLI renders a static camera.
    # With a mesh, each rank's tables cover its own band.
    with timer.phase("accel_build"):
        if mesh is None:
            tables = trace_cuda.build_cand_tables(dev, camera, config)
            gather_len = trace_cuda.seg_max_count(dev, tables)
        else:
            tables = sharded.build_cand_tables_sharded(mesh, dev, camera, config)
            gather_len = sharded.seg_max_count_sharded(mesh, dev, tables)
        if gather_len is not None:
            tables = trace_cuda.narrow_cand_tables(tables, gather_len)

    def run(st):
        if mesh is not None:
            return sharded.render_frame_sharded(mesh, dev, camera, st, config, denoiser=denoiser,
                                                cand_tables=tables, gather_len=gather_len)
        return render_frame(dev, camera, st, config, denoiser=denoiser,
                            cand_tables=tables, gather_len=gather_len)

    # The first frame (kernel builds, library set-up) counts as setup, as the
    # reference's pipeline compilation does (optixHello.cpp:1156).
    with timer.phase("first_frame"):
        image, state = run(state)
        sync()
    setup_time = time.perf_counter() - setup_start
    say(f"Setup took : {setup_time * 1000:.1f}ms")

    if args.viewer:
        from .viewer import run_viewer

        run_viewer(dev, config, camera, denoiser=denoiser)
        return 0

    if args.http_viewer is not None:
        from .viewer import InteractiveSession
        from .viewer_http import HttpViewer

        session = InteractiveSession(dev, config, camera, denoiser=denoiser)
        HttpViewer(session, port=args.http_viewer).serve_forever()
        return 0

    profile_cm = contextlib.nullcontext()
    if args.profile:
        from .utils.timing import trace_to

        profile_cm = trace_to(args.profile)

    with profile_cm:
        for f in range(args.frames - 1):
            with timer.phase("frame"):
                image, state = run(state)
                sync()
            metrics.inc("frames")
            metrics.inc("rays", scene.width * scene.height * args.rays)
            say(f"\rframe : {f + 1}", end="", flush=True)
    if timer.phases.get("frame"):
        mean_ms = timer.mean_ms("frame")
        say(f"\nAverage frame time : {mean_ms:.2f}ms")
        metrics.set("mean_frame_ms", round(mean_ms, 3))
        metrics.set(
            "rays_per_sec",
            round(scene.width * scene.height * args.rays / (mean_ms / 1000.0)),
        )
    if args.stats:
        say(timer.report())
        say(metrics.dump())

    if args.save_session:
        from .utils.checkpoint import save_session

        if mesh is not None:  # the file holds the whole frame's history
            state = sharded.gather_frame_state(mesh, state)
        if lead:
            print(f"saved session to {save_session(args.save_session, state, camera)}")

    if mesh is not None:
        image = sharded.gather_rows(mesh, image)
    if lead:
        path = save_image(image, args.out, flip_vertical=not args.no_diffusion_save)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
