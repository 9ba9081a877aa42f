"""Port RNG and sincos vs the JAX package: bit-exact.

Raygen keys its jitter on the global ray id; every path (JAX oracle, Pallas,
the port's plain version and its CUDA kernel) must draw the same bits and
the same directions, so these are compared bit for bit (tolerance 0)."""

import numpy as np
import pytest
import torch

from raytracingdiffusioncurves_tpu.ops import fastmath as jfm
from raytracingdiffusioncurves_tpu.ops import rng as jrng
from raytracingdiffusioncurves_torch.ops import fastmath as tfm
from raytracingdiffusioncurves_torch.ops import rng as trng


def _ray_ids(n=1 << 20):
    rng = np.random.default_rng(0)
    ids = np.arange(n, dtype=np.int64) * 131 + 7
    ids[: n // 4] = rng.integers(0, 2**31 - 1, n // 4)  # large ids too
    return ids.astype(np.int32)


@pytest.mark.parametrize("seed,frame", [(0, 0), (3, 17), (2**31 - 1, 123456789)])
def test_hash_and_uniforms_bit_equal(seed, frame):
    ids = _ray_ids()
    tids = torch.from_numpy(ids)
    hj = np.asarray(jrng.hash_words(seed, ids, frame)).astype(np.int64)
    ht = trng.hash_words(seed, tids, frame).numpy()
    assert np.array_equal(hj, ht)
    for a, b in zip(jrng.uniform3(seed, ids, frame), trng.uniform3(seed, tids, frame)):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy().view(np.int32))
    ua = np.asarray(jrng.uniform(seed, ids, frame, 5))
    ub = trng.uniform(seed, tids, frame, 5).numpy()
    assert np.array_equal(ua.view(np.int32), ub.view(np.int32))


def test_sincos_bit_equal():
    rng = np.random.default_rng(1)
    th = np.concatenate([
        np.linspace(0.0, 4.0 * np.pi, 1 << 20, endpoint=False),
        rng.uniform(0.0, 4.0 * np.pi, 1 << 18),
    ]).astype(np.float32)
    sj, cj = (np.asarray(v) for v in jfm.sincos(th))
    st, ct = (v.numpy() for v in tfm.sincos(torch.from_numpy(th)))
    assert np.array_equal(sj.view(np.int32), st.view(np.int32))
    assert np.array_equal(cj.view(np.int32), ct.view(np.int32))


def test_raygen_past_2_32_ray_ids():
    """Ray ids of BASELINE config 5 (3840x2160 x 1024 rpp) run to 8.49e9,
    past 2^31 and 2^32.  Every version keys the RNG on the id modulo 2^32
    (the JAX package multiplies in int32, which wraps, and casts to uint32;
    the kernel multiplies in uint32; the plain version in int64, masked), so
    jitter and directions agree bit for bit; pixels p and p + 2^32 / 1024
    draw the same streams, a property of the JAX package the port keeps."""
    from raytracingdiffusioncurves_tpu.config import Camera as JCamera
    from raytracingdiffusioncurves_tpu.config import RenderConfig as JConfig
    from raytracingdiffusioncurves_tpu.ops import intersect as jint
    from raytracingdiffusioncurves_torch.config import Camera, RenderConfig
    from raytracingdiffusioncurves_torch.ops import intersect as tint

    w, h, rpp = 3840, 2160, 1024
    rng = np.random.default_rng(2)
    last = rng.integers((h - 16) * w, h * w, 2048)  # the last 16 rows: ids past 2^32
    edges = np.concatenate([np.arange(-4, 4) + (1 << k) // rpp for k in (31, 32)])
    pix = np.repeat(np.concatenate([last, edges]), rpp)
    samp = np.tile(np.arange(rpp), pix.size // rpp)
    ids = pix.astype(np.int64) * rpp + samp
    assert ids.max() > 2**32 + 2**31 and (ids < 2**31).any() and ((ids >= 2**31) & (ids < 2**32)).any()
    kw = dict(rays_per_pixel=rpp, seed=5)
    cam = (0.8, 12.5, -3.0)
    oj, dj = jint.make_rays(pix.astype(np.int32), samp.astype(np.int32), w, h, JCamera(*cam),
                            JConfig(**kw), 7)
    ot, dt = tint.make_rays(torch.from_numpy(pix), torch.from_numpy(samp), w, h, Camera(*cam),
                            RenderConfig(**kw), 7)
    for a, b in ((oj, ot), (dj, dt)):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy().view(np.int32))
    # the JAX package's word: the int32 product, wrapped, as its raygen forms it
    words = pix.astype(np.int32) * np.int32(rpp) + samp.astype(np.int32)
    for a, b in zip(jrng.uniform3(5, words, 7), trng.uniform3(5, torch.from_numpy(ids), 7)):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy().view(np.int32))
    wrap = torch.from_numpy(ids[:rpp] + (1 << 32))
    for a, b in zip(trng.uniform3(5, torch.from_numpy(ids[:rpp]), 7), trng.uniform3(5, wrap, 7)):
        assert torch.equal(a, b)
