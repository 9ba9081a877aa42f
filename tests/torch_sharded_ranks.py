"""The ranks' side of ``test_torch_sharded.py``: what each spawned gloo rank
runs.  Spawned ranks import the module that defines their function, so this
one imports only torch, numpy and the port (no JAX): the scene XMLs come in
as arguments, and every comparison with one process or with the JAX package
stays in the test process."""

import dataclasses
import os
import sys

import numpy as np
import torch

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.models import denoiser as tdn
from raytracingdiffusioncurves_torch.parallel import sharded
from raytracingdiffusioncurves_torch.utils.scenes import seeded_scene_xml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "denoiser_r3d.msgpack")


def scene(xml, flatten=8):
    return rt.build_device_scene(rt.load_scene_from_string(xml), flatten_subdivisions=flatten,
                                 device="cpu")


def seeded():
    """64^2 seeded scene, 128 padded sub-segments: slot-mode lists."""
    return scene(seeded_scene_xml(0, 64, 64), flatten=16)


TRACE_CFG = dict(rays_per_pixel=8, use_blur=False, use_denoiser=False)
FRAME_CFG = dict(rays_per_pixel=8)
PROG_CFG = dict(rays_per_pixel=4, use_denoiser=False)
DENSE_CFG = dict(rays_per_pixel=8, use_blur=False, use_denoiser=False)


def train_batch(n=4, size=16):
    rng = np.random.default_rng(7)
    target = rng.uniform(size=(n, size, size, 3)).astype(np.float32)
    return {"noisy": (target + 0.2 * rng.standard_normal(target.shape)).astype(np.float32),
            "warped_prev": rng.uniform(size=(n, size, size, 3)).astype(np.float32),
            "aux": rng.uniform(size=(n, size, size, 2)).astype(np.float32),
            "target": target}


def new_model():
    return tdn.create_train_state(torch.Generator().manual_seed(0), 16, 16, lr=1e-3,
                                  arch="unet", base=8, device="cpu")


def band_state(mesh, w=64, h=64):
    return sharded.frame_state_sharded(mesh, rt.init_frame_state(w, h, device="cpu"))


# The chained sequence on the seeded 64^2 scene after its first three frames:
# (camera, zoom step of the flow or None, denoiser: "unet", "analytic" or
# "off").  The zoom frames have a non-zero flow (the history is warped); the
# others rest.
MOVES = [(rt.Camera(0.9), (1.0, 0.9), "unet"), (rt.Camera(0.9), None, "unet"),
         (rt.Camera(0.81), (0.9, 0.81), "analytic"), (rt.Camera(0.81), None, "off")]


def move_config(kind):
    return rt.RenderConfig(**FRAME_CFG, **({"use_denoiser": False} if kind == "off" else {}))


def moving_frames(mesh, dt, net, st, gather):
    """MOVES chained from ``st`` (a band state): each frame's gathered image
    and this rank's exchange log; the final band state's history and flow."""
    out = []
    for cam, zoom, kind in MOVES:
        if zoom is not None:
            st = dataclasses.replace(st, flow=sharded.add_zoom_flow_sharded(mesh, st.flow, *zoom))
        img, st = sharded.render_frame_sharded(mesh, dt, cam, st, move_config(kind),
                                               denoiser=net if kind == "unet" else None)
        log = list(sharded.EXCHANGE_LOG)
        out.append((gather(img), log))
    return out, (st.prev_image.numpy(), st.flow.numpy(), st.frame, st.flow_is_zero)


def rank_work(rank, world, xmls):
    """Everything the test module compares, on one rank; host data only.
    ``xmls``: the scenes by name ("curve" 64^2, "odd" 64 x 63, "band6" 64 x
    68: bands of 34 rows, "dense")."""
    mesh = sharded.make_mesh(world, device_type="cpu")
    gather = lambda t: sharded.gather_rows(mesh, t).numpy()  # noqa: E731
    out = {"rank": rank, "size": mesh.size(), "names": mesh.mesh_dim_names,
           "jax_modules": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "raytracingdiffusioncurves_tpu"))}
    cam = rt.Camera()

    dt = scene(xmls["curve"])
    img, bm = sharded.trace_image_sharded(mesh, dt, cam, rt.RenderConfig(**TRACE_CFG))
    out["trace_band"] = img.numpy()
    out["trace"] = (gather(img), gather(bm))

    cfg = rt.RenderConfig(**FRAME_CFG)
    dt = seeded()
    tabs = sharded.build_cand_tables_sharded(mesh, dt, cam, cfg)
    gl = sharded.seg_max_count_sharded(mesh, dt, tabs)
    out["gather_len"] = gl
    st = band_state(mesh)
    frames = []
    for _ in range(2):
        img, st = sharded.render_frame_sharded(mesh, dt, cam, st, cfg, cand_tables=tabs,
                                               gather_len=gl)
        out["rest_log"] = list(sharded.EXCHANGE_LOG)
        frames.append(gather(img))
    net = rt.net_for_params(rt.load_params(WEIGHTS), device="cpu")
    img, st = sharded.render_frame_sharded(mesh, dt, rt.Camera(1.1, 2.0, -1.0), st, cfg,
                                           denoiser=net)
    frames.append(gather(img))
    out["frames"], out["prev"], out["frame"] = frames, st.prev_image.numpy(), st.frame
    out["moves"], out["moved_state"] = moving_frames(mesh, dt, net, st, gather)
    whole = sharded.gather_frame_state(mesh, st)
    out["whole_state"] = (whole.prev_image.numpy(), whole.flow.numpy(), whole.flow_is_zero)

    pcfg = rt.RenderConfig(**PROG_CFG)
    st = band_state(mesh)
    prog = rt.init_progressive_state(64, 64 // world, device="cpu")
    passes = []
    for reset in (True, False, True, False):
        img, st, prog = sharded.render_frame_progressive_sharded(mesh, dt, cam, st, prog, pcfg,
                                                                 reset)
        passes.append((gather(img), gather(prog.weight_sum), prog.passes))
    out["progressive"] = passes
    try:
        sharded.render_frame_sharded(mesh, dt, cam, rt.init_frame_state(64, 64, device="cpu"),
                                     cfg)
    except ValueError as e:
        out["whole_state_refused"] = str(e)

    dense = scene(xmls["dense"])
    dcfg = rt.RenderConfig(**DENSE_CFG)
    dtabs = sharded.build_cand_tables_sharded(mesh, dense, cam, dcfg)
    out["dense_dist_ordered"] = dtabs.dist_ordered
    out["dense_gather_len"] = sharded.seg_max_count_sharded(mesh, dense, dtabs)
    img, bm = sharded.trace_image_sharded(mesh, dense, cam, dcfg, 1, cand_tables=dtabs)
    out["dense"] = (gather(img), gather(bm))
    out["dense_band"] = [t.numpy() for t in sharded.trace_sums_sharded(
        mesh, dense, cam, dcfg, 1, cand_tables=dtabs)]

    model, sched, opt = new_model()
    batch = {k: torch.from_numpy(v[2 * rank : 2 * rank + 2]) for k, v in train_batch().items()}
    loss = tdn.train_step(model, opt, sched, batch, group=sharded.group(mesh))
    out["train"] = (float(loss), tdn.params_to_jax(model),
                    {n: p.grad.numpy().copy() for n, p in model.named_parameters()})

    try:
        sharded.trace_image_sharded(mesh, scene(xmls["odd"]), cam, rt.RenderConfig(**TRACE_CFG))
    except ValueError as e:
        out["odd_height"] = str(e)
    band6 = scene(xmls["band6"])
    out["band6_trace"] = gather(sharded.trace_image_sharded(mesh, band6, cam,
                                                            rt.RenderConfig(**TRACE_CFG))[0])
    st = band_state(mesh, 64, 68)
    out["band6_frames"] = []
    for denoiser in (None, None, net):
        img, st = sharded.render_frame_sharded(mesh, band6, cam, st, cfg, denoiser=denoiser)
        out["band6_log"] = list(sharded.EXCHANGE_LOG)
        out["band6_frames"].append(gather(img))
    try:
        sharded.make_mesh(3, device_type="cpu")
    except ValueError as e:
        out["mesh_of_3"] = str(e)
    return out


def rank_work_wide_halo(rank, world):
    """Four ranks, bands of 16 rows: the UNet's halo (20 rows) takes rows
    from two ranks.  The seeded sequence's first frames with the UNet (its
    frame 0, a resting frame), then MOVES; and two UNet frames of the
    seeded scene at 64 x 68, bands of 17 rows."""
    mesh = sharded.make_mesh(world, device_type="cpu")
    gather = lambda t: sharded.gather_rows(mesh, t).numpy()  # noqa: E731
    dt = seeded()
    net = rt.net_for_params(rt.load_params(WEIGHTS), device="cpu")
    cfg = rt.RenderConfig(**FRAME_CFG)
    st = band_state(mesh)
    frames, logs = [], []
    for _ in range(2):
        img, st = sharded.render_frame_sharded(mesh, dt, rt.Camera(), st, cfg, denoiser=net)
        logs.append(list(sharded.EXCHANGE_LOG))
        frames.append(gather(img))
    moves, state = moving_frames(mesh, dt, net, st, gather)
    tall = scene(seeded_scene_xml(0, 64, 68), flatten=16)
    st = band_state(mesh, 64, 68)
    tall_frames = []
    for _ in range(2):
        img, st = sharded.render_frame_sharded(mesh, tall, rt.Camera(), st, cfg, denoiser=net)
        tall_log = list(sharded.EXCHANGE_LOG)
        tall_frames.append(gather(img))
    return {"frames": frames, "logs": logs, "moves": moves, "moved_state": state,
            "tall_frames": tall_frames, "tall_log": tall_log}


def fail_on_rank_1(rank, world):
    if rank == 1:
        raise KeyError("rank 1 fails")
    # rank 0 waits in a collective that rank 1 never joins: it is ended
    torch.distributed.barrier()
