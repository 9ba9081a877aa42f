"""The ranks' side of ``test_torch_sharded.py`` and of the row-band cases of
``test_torch_cuda_paths.py``: what each spawned gloo rank runs.  Spawned
ranks import the module that defines their function, so this one imports
only torch, numpy and the port (no JAX): the scene XMLs come in as
arguments, and every comparison with one process or with the JAX package
stays in the test process."""

import contextlib
import dataclasses
import functools
import os
import sys

import numpy as np
import torch

import raytracingdiffusioncurves_torch as rt
from raytracingdiffusioncurves_torch.models import denoiser as tdn
from raytracingdiffusioncurves_torch.ops import conv_cuda, trace_cuda
from raytracingdiffusioncurves_torch.ops.blur import blur_radius
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


# The trace split by work (sharded.build_cand_tables_sharded): the seeded
# scene zoomed out into the frame's top rows; 2-row tiles (rays_per_block
# 128), so the split has 32 tile rows to cut; the blur on, the denoiser off.
SPLIT_CAMERA = rt.Camera(2.0, 0.0, -40.0)
SPLIT_CFG = dict(rays_per_pixel=32, rays_per_block=128, use_denoiser=False)


def split_cost_ms(scene, camera, config, r0, r1, tables):
    """A fixed cost by row for the split's timer (``split_by_cost``): the
    first 20 rows three times the others.  The plain trace costs about the
    same on every row, and its times on a host that runs other tests are
    noise, so the real timer would cut at random; the card's cases but
    "split" run the real one."""
    return float(sum(3.0 if r < 20 else 1.0 for r in range(r0, r1)))


@contextlib.contextmanager
def split_by_cost():
    """``split_cost_ms`` in the split's timer's place (``sharded._trace_ms``)."""
    timer, sharded._trace_ms = sharded._trace_ms, split_cost_ms
    try:
        yield
    finally:
        sharded._trace_ms = timer


def split_frames(mesh, gather):
    """The seeded scene at SPLIT_CAMERA: two chained frames on hoisted
    tables (split by work as ``split_cost_ms`` times the rows, narrowed),
    then one on in-frame tables, each
    with its gathered image, this rank's traced rows and its exchange log;
    the tables' cuts before and after narrowing (to the certified length,
    and to 8 slots, which cuts the lists); the final band state; two
    progressive passes (reset, then add) on the hoisted tables."""
    dt = seeded()
    cfg = rt.RenderConfig(**SPLIT_CFG)
    with split_by_cost():
        tabs = sharded.build_cand_tables_sharded(mesh, dt, SPLIT_CAMERA, cfg)
    gl = sharded.seg_max_count_sharded(mesh, dt, tabs)
    narrow = trace_cuda.narrow_cand_tables(tabs, gl)
    short = trace_cuda.narrow_cand_tables(tabs, 8)  # lists cut, the fields kept
    out = {"cuts": tabs.row_cuts, "narrow_cuts": (narrow.row_cuts, short.row_cuts),
           "narrowed": short.ids.shape[-1] == 8 < tabs.ids.shape[-1], "frames": []}
    st = band_state(mesh)
    for tables in (narrow, narrow, None):
        rows = sharded.trace_rows(mesh, dt, tables)
        img, st = sharded.render_frame_sharded(mesh, dt, SPLIT_CAMERA, st, cfg,
                                               cand_tables=tables,
                                               gather_len=None if tables is None else gl)
        log = list(sharded.EXCHANGE_LOG)
        out["frames"].append((gather(img), rows, log))
    out["state"] = (st.prev_image.numpy(), st.frame)
    st = band_state(mesh)
    prog = rt.init_progressive_state(64, 64 // mesh.size(), device="cpu")
    out["progressive"] = []
    for reset in (True, False):
        img, st, prog = sharded.render_frame_progressive_sharded(
            mesh, dt, SPLIT_CAMERA, st, prog, cfg, reset, cand_tables=narrow, gather_len=gl)
        out["progressive"].append((gather(img), gather(prog.weight_sum)))
    return out


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
    out["split"] = split_frames(mesh, gather)
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
    frame 0, a resting frame), then MOVES; two UNet frames of the seeded
    scene at 64 x 68, bands of 17 rows; and ``split_frames``."""
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
            "tall_frames": tall_frames, "tall_log": tall_log, "split": split_frames(mesh, gather)}


def fail_on_rank_1(rank, world):
    if rank == 1:
        raise KeyError("rank 1 fails")
    # rank 0 waits in a collective that rank 1 never joins: it is ended
    torch.distributed.barrier()


# ---------------------------------------------------------------------------
# two ranks that share one card (test_torch_cuda_paths.py)
# ---------------------------------------------------------------------------


def band_sequences(mesh, device, cases, net):
    """The row-band cases on ``device``: this rank's band (``mesh``) or the
    whole frame (``mesh`` None).  ``cases``: name -> (scene XML,
    RenderConfig keywords, camera).  Each chains frames on hoisted tables
    narrowed to their largest count ("dense" one, the others two; the
    tables, and the sharded split's timed launches, come before the launch
    counters are reset; "split" is timed by ``split_by_cost``, the others
    by the real timer), with
    ``net`` where the denoiser is on; then "unet" takes a zoom step and
    "off" two progressive passes ("progressive").  Returns {name: a record
    a frame} (host data), "reach" (the largest halo a stage reads),
    "wedge_shift" and "cuts" (the tables' ``row_cuts``) by case."""
    if mesh is None:
        tables, count, frame = rt.build_cand_tables, rt.seg_max_count, rt.render_frame
        progressive, zoom = rt.render_frame_progressive, rt.add_zoom_flow
        band_state, band_rows = (lambda st: st), (lambda h: h)
    else:
        tables = functools.partial(sharded.build_cand_tables_sharded, mesh)
        count = functools.partial(sharded.seg_max_count_sharded, mesh)
        frame = functools.partial(sharded.render_frame_sharded, mesh)
        progressive = functools.partial(sharded.render_frame_progressive_sharded, mesh)
        zoom = functools.partial(sharded.add_zoom_flow_sharded, mesh)
        band_state = functools.partial(sharded.frame_state_sharded, mesh)
        band_rows = lambda h: h // mesh.size()  # noqa: E731
    out = {"reach": {}, "wedge_shift": {}, "cuts": {}}

    def record(name, img, st, moved=False):
        out.setdefault(name, []).append(dict(
            image=img.cpu().numpy(), prev=st.prev_image.cpu().numpy(), frame=st.frame,
            flow_zero=st.flow_is_zero, moved=moved,
            launches=(trace_cuda.LAUNCHES, conv_cuda.LAUNCHES), log=list(sharded.EXCHANGE_LOG)))

    def hoisted(dt, cam, cfg):
        tabs = tables(dt, cam, cfg)
        gl = count(dt, tabs)
        return (tabs if gl is None else trace_cuda.narrow_cand_tables(tabs, gl)), gl

    for name, (xml, kw, cam) in cases.items():
        dt = rt.build_device_scene(rt.load_scene_from_string(xml), device=device)
        cfg = rt.RenderConfig(**kw)
        den = net if cfg.use_denoiser else None
        radius = blur_radius(dt.max_blur)
        out["reach"][name] = max(radius, tdn.band_halo(net)) if den is not None else radius
        with split_by_cost() if name == "split" else contextlib.nullcontext():
            tabs, gl = hoisted(dt, cam, cfg)
        if name == "unet":  # hoisted before the frames count their launches, as tabs
            zcam = rt.Camera(zoom_factor=0.9)
            ztabs, zgl = hoisted(dt, zcam, cfg)
        n_wedges = trace_cuda._grid_geom(dt, cfg, dt.width, dt.width * dt.height)[3]
        out["wedge_shift"][name] = trace_cuda.table_wedge_shift(tabs, n_wedges)
        out["cuts"][name] = tabs.row_cuts
        st = band_state(rt.init_frame_state(dt.width, dt.height, device=device))
        trace_cuda.reset_launch_count()
        conv_cuda.reset_launch_count()
        for _ in range(1 if name == "dense" else 2):
            img, st = frame(dt, cam, st, cfg, denoiser=den, cand_tables=tabs, gather_len=gl)
            record(name, img, st)
        if name == "unet":
            moved = dataclasses.replace(st, flow=zoom(st.flow, 1.0, 0.9))
            img, st = frame(dt, zcam, moved, cfg, denoiser=den, cand_tables=ztabs, gather_len=zgl)
            record(name, img, st, moved=not moved.flow_is_zero)
        if name == "off":
            st = band_state(rt.init_frame_state(dt.width, dt.height, device=device))
            prog = rt.init_progressive_state(dt.width, band_rows(dt.height), device=device)
            trace_cuda.reset_launch_count()
            out["reach"]["progressive"] = radius
            for reset in (True, False):
                img, st, prog = progressive(dt, cam, st, prog, cfg, reset, cand_tables=tabs,
                                            gather_len=gl)
                record("progressive", img, st)
    return out


def unet_train_step(batch, device, group=None):
    """One train step of the UNet at the shipped width (base 24) from a
    seeded initial state on ``batch`` (host arrays), the gradients
    all-reduced over ``group``: (loss, gradients by parameter name)."""
    h, w = batch["noisy"].shape[1:3]
    model, sched, opt = tdn.create_train_state(torch.Generator().manual_seed(0), h, w, 2e-3,
                                               arch="unet", base=24, device=device)
    loss = tdn.train_step(model, opt, sched,
                          {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                          group=group)
    return float(loss), {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}


def rank_work_on_one_card(rank, world, device, cases, batch):
    """A gloo rank on ``device`` ("cuda": every rank on cuda:0, which NCCL
    refuses): the collectives on that device's tensors, band_sequences of
    ``cases`` with the shipped UNet, and the data-parallel train step on
    this rank's share of ``batch``.  Host data only."""
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = sharded.make_mesh(world, device_type=device)
    probe = sharded.gather_rows(mesh, torch.full((4,), float(rank), device=device))
    top = torch.tensor([rank + 3], dtype=torch.int64, device=device)
    torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX)
    out = {"collectives": (probe.device.type, probe.tolist(), int(top))}
    net = rt.net_for_params(rt.load_params(WEIGHTS), device=device)
    out["bands"] = band_sequences(mesh, device, cases, net)
    share = batch["noisy"].shape[0] // world
    out["train"] = unet_train_step({k: v[rank * share : (rank + 1) * share]
                                    for k, v in batch.items()}, device, sharded.group(mesh))
    return out
