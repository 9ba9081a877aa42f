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
