"""Self-supervised training for the learned denoiser (the JAX package's
``models/train_denoiser.py``, the same data and recipe).

The OptiX denoiser the reference uses is a pretrained network
(optixHello.cpp:1057); this one trains directly on the renderer's own output,
with no external dataset: for random scenes and cameras, render a noisy
low-rpp frame (+ the flow-warped previous output, matching the temporal guide
layout, optixHello.cpp:1115-1127) and supervise against a high-rpp render of
the same view.  The rendering is done once into an .npz dataset (scenes x
cameras x noise levels, float16), then training draws random crops with
flip/transpose augmentation in shuffled minibatches, conditioned on a
noise-level channel, and validates on held-out scenes.

Both packages draw the same cameras from the same seed and write the same
``.npz`` keys, shards and checkpoints (flax MessagePack), so a dataset or a
checkpoint written by either is read by the other.  Where the JAX trainer
takes ``--backend`` (gen) and ``--device cpu|auto`` with the CPU as default
(train), this one takes ``--device auto|cpu`` for both, ``auto`` (the
default) being the CUDA card: renders then run the trace kernel, validation
the convolution kernel.

Usage:
    # 1. render the dataset
    python -m raytracingdiffusioncurves_torch.models.train_denoiser gen \\
        --out denoise_data.npz [--val-out denoise_val.npz] [--device cpu]
    # 2. train on crops
    python -m raytracingdiffusioncurves_torch.models.train_denoiser train \\
        --data denoise_data.npz --val denoise_val.npz --out denoiser.msgpack

``XMLS`` is joined with each scene name, so absolute paths (e.g. scenes
generated by ``utils/scenes.py``) pass through unchanged.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from ..config import Camera, RenderConfig
from ..models import denoiser as dn
from ..models import renderer
from ..ops import flow as flow_ops
from ..scene.device import build_device_scene
from ..scene.xml_loader import load_scene
from ..utils.checkpoint import save_params
from ..utils.devices import resolve_device

# The reference scene XMLs, where they go once they are part of this checkout
# (not yet: relative scene names then fail before anything renders).
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
XMLS = os.path.join(_CHECKOUT, "reference", "optixHello", "xmls")
# Held-out scenes never seen in training (validation generalization check).
VAL_SCENES = ("weight_demo.xml", "DiffusionCurvePack/zephyr.xml")
TRAIN_SCENES = (
    "arch.xml",
    "arch2.xml",
    "circles.xml",
    "endcap.xml",
    "line.xml",
    "PortalDemo.xml",
    "test.xml",
    "test2.xml",
    "test3.xml",
    "test4.xml",
    "test5.xml",
    "DiffusionCurvePack/lady_bug.xml",
    "DiffusionCurvePack/drape.xml",
    "DiffusionCurvePack/face.xml",
    "DiffusionCurvePack/roses_spirales.xml",
    "DiffusionCurvePack/behindthecurtain.xml",
    "DiffusionCurvePack/fille.xml",
    "DiffusionCurvePack/dolphin.xml",
    "DiffusionCurvePack/lady_bug1024.xml",
)
# Noise levels of the dataset's noisy renders, one per camera in turn
# (rpp 64 so the net sees near-clean inputs too).
RPP_LEVELS = (4, 8, 16, 32, 64)


def sample_example(dev, rng: np.random.Generator, size: int, frame: int,
                   rpp_lo: int = 8, rpp_hi: int = 256):
    """One (noisy, warped_prev, aux, target) example from a random camera,
    rendered on the scene's device: three trace_image calls (noisy, target,
    and the previous frame at 1.1x the zoom, warped back by the true flow)."""
    zoom = float(np.exp(rng.uniform(np.log(0.3), np.log(2.0))))
    off = rng.uniform(-100, 100, 2)
    cam = Camera(zoom, float(off[0]), float(off[1]))
    lo = RenderConfig(rays_per_pixel=rpp_lo, use_blur=False, use_denoiser=False, seed=frame)
    hi = RenderConfig(rays_per_pixel=rpp_hi, use_blur=False, use_denoiser=False, seed=frame)
    noisy, blur_map = renderer.trace_image(dev, cam, lo, frame)
    target, _ = renderer.trace_image(dev, cam, hi, frame)
    zoom_prev = zoom * 1.1
    prev, _ = renderer.trace_image(dev, Camera(zoom_prev, cam.offset_x, cam.offset_y), lo, frame + 1)
    fl = flow_ops.add_zoom_flow(
        flow_ops.zero_flow(*noisy.shape[:2], device=noisy.device), zoom_prev, zoom)
    warped = flow_ops.warp_by_flow(prev, fl)
    return dn.make_batch_from_renders(noisy, target, warped, blur_map,
                                      noise=dn.noise_level(rpp_lo))


def generate(scene_names, out_path, size=192, cams_per_scene=6, seed=0,
             device=None, chunk_cams=9):
    """Render a dataset: every scene x camera x noise level, saved float16.

    Checkpointed per (scene, camera chunk): each chunk's examples land in
    ``<out_path>.shards/`` the moment they finish, and existing shards are
    skipped on re-run, so a killed run resumes where it stopped.  The RNG is
    re-seeded per chunk (``default_rng([seed, scene index, first camera])``)
    so a resumed run draws the cameras it would have drawn fresh.
    ``scene_names``: a list, or a dict index -> name whose indices keep shard
    names and seeds stable under filtering."""
    on = resolve_device(device)
    pairs = (list(scene_names.items()) if isinstance(scene_names, dict)
             else list(enumerate(scene_names)))
    missing = [os.path.join(XMLS, n) for _, n in pairs
               if not os.path.isfile(os.path.join(XMLS, n))]
    if missing:
        raise FileNotFoundError(f"scene XMLs not found: {missing} (give absolute paths)")
    shard_dir = str(out_path) + ".shards"
    os.makedirs(shard_dir, exist_ok=True)
    shard_paths = []
    for si, name in pairs:
        slug = name.replace("/", "_").removesuffix(".xml")
        chunks = [(c0, min(c0 + chunk_cams, cams_per_scene))
                  for c0 in range(0, cams_per_scene, chunk_cams)]
        scene_shards = [os.path.join(shard_dir, f"{si:02d}_{slug}.{c0:03d}.npz")
                        for c0, _ in chunks]
        shard_paths += scene_shards
        if all(os.path.exists(p) for p in scene_shards):
            print(f"{name}: all shards exist, skipping", flush=True)
            continue
        t0 = time.time()
        scene = load_scene(os.path.join(XMLS, name)).with_size(size, size)
        dev = build_device_scene(scene, flatten_subdivisions=8, device=on)
        for (c0, c1), sp in zip(chunks, scene_shards):
            if os.path.exists(sp):
                continue
            rng = np.random.default_rng([seed, si, c0])
            rows = {"noisy": [], "warped_prev": [], "aux": [], "target": []}
            for c in range(c0, c1):
                rpp = int(RPP_LEVELS[c % len(RPP_LEVELS)])
                b = sample_example(dev, rng, size, frame=si * 1000 + c * 7, rpp_lo=rpp)
                for k in rows:
                    rows[k].append(b[k][0].cpu().numpy().astype(np.float16))
            tmp = sp + ".tmp.npz"
            np.savez_compressed(tmp, **{k: np.stack(v) for k, v in rows.items()})
            os.replace(tmp, sp)
            print(f"  {name} cams {c0}:{c1} done ({time.time() - t0:.0f}s)", flush=True)
        print(f"{name}: {cams_per_scene} examples ({time.time() - t0:.0f}s)", flush=True)
    data = [dict(np.load(p)) for p in shard_paths]
    np.savez_compressed(out_path, **{k: np.concatenate([d[k] for d in data]) for k in data[0]})
    print(f"wrote {out_path}")


def _crop_batch(data, rng: np.random.Generator, batch: int, crop: int, device=None):
    """Random crops + dihedral augmentation from the f16 dataset, as float32
    tensors on ``device`` (None = CUDA).  The draws are the JAX trainer's."""
    n, h, w = data["noisy"].shape[:3]
    idx = rng.integers(n, size=batch)
    ys = rng.integers(h - crop + 1, size=batch)
    xs = rng.integers(w - crop + 1, size=batch)
    flips = rng.integers(4, size=batch)
    out = {k: [] for k in data}
    for i in range(batch):
        for k in data:
            v = data[k][idx[i], ys[i] : ys[i] + crop, xs[i] : xs[i] + crop]
            if flips[i] & 1:
                v = v[::-1]
            if flips[i] & 2:
                v = v[:, ::-1]
            out[k].append(v.astype(np.float32))
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.stack(v)).to(dev) for k, v in out.items()}


def _psnr_vs_target(model, params, data) -> float:
    """Full-image PSNR of the denoised output over a dataset (uint8 domain,
    matching utils.image.psnr semantics).  ``params`` (the JAX package's
    tree) runs through the inference module, ``net_for_params``, on
    ``model``'s device: the convolution kernel on the card."""
    from ..utils.image import psnr, to_uint8

    device = next(model.parameters()).device
    net = dn.net_for_params(params, device=device)

    def q(x):
        return to_uint8(x, False).astype(np.float64) / 255.0

    vals = []
    with torch.no_grad():
        for i in range(data["noisy"].shape[0]):
            b = {k: torch.from_numpy(np.asarray(data[k][i : i + 1], np.float32)).to(device)
                 for k in data}
            pred = net(b["noisy"], b["warped_prev"], b["aux"])
            vals.append(psnr(q(pred[0]), q(b["target"][0])))
    return float(np.mean(vals))


def _psnr_noisy(data) -> float:
    from ..utils.image import psnr, to_uint8

    def q(x):
        return to_uint8(np.asarray(x, np.float32), False).astype(np.float64) / 255.0

    return float(np.mean([psnr(q(data["noisy"][i]), q(data["target"][i]))
                          for i in range(data["noisy"].shape[0])]))


def train(data_path, val_path, out_path, steps=4000, batch=32, crop=64,
          lr=2e-3, seed=0, arch="cnn", base=None, ema_decay=0.999, device=None):
    """Train on crops of the dataset at ``data_path`` (one .npz or a
    comma-separated list, concatenated), validate on ``val_path`` every 250
    steps, keep the best of the raw and the EMA weights by validation PSNR,
    and write them to ``out_path``.  Returns the run's numbers: the last
    loss, the best validation PSNR and the noisy inputs' PSNR (None without
    a validation set), and the mean time of a train step (CUDA events on
    the card, the host clock on the CPU)."""
    dev = resolve_device(device)
    parts = [dict(np.load(p)) for p in str(data_path).split(",")]
    data = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    val = dict(np.load(val_path)) if val_path else None
    rng = np.random.default_rng(seed)

    schedule = dn.cosine_decay_schedule(lr, steps, alpha=0.1)
    model, sched, opt = dn.create_train_state(
        torch.Generator().manual_seed(seed), crop, crop, schedule, arch=arch, base=base,
        device=dev)
    params = list(model.parameters())

    # EMA of the weights alongside the raw iterates; best-val selection
    # below picks whichever candidate wins, so EMA can only help.
    ema_model = copy.deepcopy(model).requires_grad_(False)
    ema = list(ema_model.parameters())
    timers = []
    best = (-1.0, None)
    loss = None
    for step in range(steps):
        b = _crop_batch(data, rng, batch, crop, dev)
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = dn.train_step(model, opt, sched, b)
            end.record()
            timers.append((start, end))
        else:
            t0 = time.perf_counter()
            loss = dn.train_step(model, opt, sched, b)
            timers.append(time.perf_counter() - t0)
        with torch.no_grad():
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        if step % 250 == 0 or step == steps - 1:
            msg = f"step {step}: loss {float(loss):.5f}"
            if val is not None:
                raw, smooth = dn.params_to_jax(model), dn.params_to_jax(ema_model)
                vp = _psnr_vs_target(model, raw, val)
                vp_e = _psnr_vs_target(model, smooth, val)
                msg += f"  val_psnr {vp:.2f}  ema {vp_e:.2f}"
                if vp > best[0]:
                    best = (vp, raw)
                if vp_e > best[0]:
                    best = (vp_e, smooth)
            print(msg, flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        step_ms = [s.elapsed_time(e) for s, e in timers]
    else:
        step_ms = [t * 1e3 for t in timers]
    ms_per_step = float(np.mean(step_ms)) if step_ms else None

    out = best[1] if best[0] > 0 else dn.params_to_jax(model)
    noisy = None
    if val is not None:
        noisy = _psnr_noisy(val)
        print(f"best val_psnr {best[0]:.2f} (noisy {noisy:.2f})")
    if ms_per_step is not None:
        print(f"{steps} steps: {ms_per_step:.3f} ms per step on {dev}")
    save_params(out_path, out)
    print(f"wrote {out_path}")
    return {"loss": None if loss is None else float(loss),
            "best_val_psnr": best[0] if val is not None else None,
            "noisy_psnr": noisy, "ms_per_step": ms_per_step}


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracingdiffusioncurves_torch.models.train_denoiser")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen", help="render the training/validation datasets")
    g.add_argument("--out", default="denoise_data.npz")
    g.add_argument("--val-out", default=None)
    g.add_argument("--size", type=int, default=192)
    g.add_argument("--cams", type=int, default=16)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--scenes", default=None,
                   help="comma-separated substring filter over TRAIN_SCENES "
                   "(val gen is skipped when set); scene indices keep their "
                   "TRAIN_SCENES positions so shards/seeds stay stable")
    t = sub.add_parser("train", help="train on a rendered dataset")
    t.add_argument("--data", required=True)
    t.add_argument("--val", default=None)
    t.add_argument("--out", default="denoiser_params.msgpack")
    t.add_argument("--steps", type=int, default=4000)
    t.add_argument("--batch", type=int, default=32)
    t.add_argument("--crop", type=int, default=64)
    t.add_argument("--lr", type=float, default=2e-3)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--base", type=int, default=None,
                   help="channel width override (UNet base / CNN features)")
    t.add_argument("--arch", default="cnn", choices=("cnn", "unet"),
                   help="unet: multi-scale encoder/decoder (wider receptive "
                   "field; needs --crop a multiple of 4)")
    for q in (g, t):
        q.add_argument("--device", choices=("auto", "cpu"), default="auto",
                       help="auto: the CUDA card (an error without one); cpu: "
                       "the plain PyTorch version of every kernel")
    args = p.parse_args(argv)
    device = "cpu" if args.device == "cpu" else "cuda"

    if args.cmd == "gen":
        scenes = TRAIN_SCENES
        if args.scenes:
            keys = args.scenes.split(",")
            scenes = {i: n for i, n in enumerate(TRAIN_SCENES) if any(k in n for k in keys)}
        generate(scenes, args.out, args.size, args.cams, args.seed, device=device)
        if args.val_out and not args.scenes:
            generate(VAL_SCENES, args.val_out, args.size, max(args.cams // 2, 2),
                     args.seed + 1, device=device)
    else:
        train(args.data, args.val, args.out, args.steps, args.batch, args.crop,
              args.lr, args.seed, arch=args.arch, base=args.base, device=device)


if __name__ == "__main__":
    main()
