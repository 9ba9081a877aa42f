"""The ranks' side of ``test_torch_sharded.py``: what each spawned gloo rank
runs.  Spawned ranks import the module that defines their function, so this
one imports only torch, numpy and the port (no JAX): the scene XMLs come in
as arguments, and every comparison with one process or with the JAX package
stays in the test process."""

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


def rank_work(rank, world, xmls):
    """Everything the test module compares, on one rank; host data only.
    ``xmls``: the scenes by name ("curve" 64^2, "odd" 64 x 63, "dense")."""
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
    st = rt.init_frame_state(64, 64, device="cpu")
    frames = []
    for _ in range(2):
        img, st = sharded.render_frame_sharded(mesh, dt, cam, st, cfg, cand_tables=tabs,
                                               gather_len=gl)
        frames.append(gather(img))
    net = rt.net_for_params(rt.load_params(WEIGHTS), device="cpu")
    img, st = sharded.render_frame_sharded(mesh, dt, rt.Camera(1.1, 2.0, -1.0), st, cfg,
                                           denoiser=net)
    frames.append(gather(img))
    out["frames"], out["prev"], out["frame"] = frames, st.prev_image.numpy(), st.frame

    pcfg = rt.RenderConfig(**PROG_CFG)
    st = rt.init_frame_state(64, 64, device="cpu")
    prog = rt.init_progressive_state(64, 64 // world, device="cpu")
    passes = []
    for reset in (True, False, True, False):
        img, st, prog = sharded.render_frame_progressive_sharded(mesh, dt, cam, st, prog, pcfg,
                                                                 reset)
        passes.append((gather(img), gather(prog.weight_sum), prog.passes))
    out["progressive"] = passes

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
    try:
        sharded.make_mesh(3, device_type="cpu")
    except ValueError as e:
        out["mesh_of_3"] = str(e)
    return out




def fail_on_rank_1(rank, world):
    if rank == 1:
        raise KeyError("rank 1 fails")
    # rank 0 waits in a collective that rank 1 never joins: it is ended
    torch.distributed.barrier()
