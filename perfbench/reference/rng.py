"""Counter-based stateless RNG for stratified sampling jitter.

Bit-exact twin of the JAX package's ``ops/rng.py`` (the murmur3/splitmix
32-bit finalizer over a running combine of (seed, ray id, frame)); the CUDA
trace kernel computes the same hash in native uint32 (csrc/trace.cu
``hash3``).  torch has no full uint32 arithmetic, so the plain version
computes in int64 and masks to 32 bits after every add and multiply; each
multiply is split into two 16-bit halves of the constant so no int64
product overflows.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_H0 = 0x2F6E2B1


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for h in [0, 2^32): both partial products < 2^48."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def _word(w, like: torch.Tensor | None) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.to(torch.int64) & _MASK
    device = like.device if like is not None else None
    return torch.tensor(int(w) & _MASK, dtype=torch.int64, device=device)


def hash_words(*words) -> torch.Tensor:
    """Combine integer words (broadcastable int tensors or Python ints) into
    uniformly mixed 32-bit values, returned as int64 in [0, 2^32)."""
    like = next((w for w in words if isinstance(w, torch.Tensor)), None)
    h = _word(_H0, like)
    for w in words:
        w = _word(w, like)
        h = _mul32(h ^ _fmix32((w + _GOLDEN) & _MASK), _M1)
        h = (h + _GOLDEN) & _MASK
    return _fmix32(h)


def uniform(*words) -> torch.Tensor:
    """U[0, 1) float32 from hashed words: the top 23 bits into the mantissa
    of [1, 2), minus 1."""
    bits = hash_words(*words)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return f.view(torch.float32) - 1.0


def uniform3(*words):
    """Three U[0, 1) streams from ONE hash, bit-sliced (11+11+10 bits), as
    the JAX package's ``uniform3``."""
    bits = hash_words(*words)
    u0 = (bits >> 21).to(torch.float32) * (1.0 / 2048.0)
    u1 = ((bits >> 10) & 0x7FF).to(torch.float32) * (1.0 / 2048.0)
    u2 = (bits & 0x3FF).to(torch.float32) * (1.0 / 1024.0)
    return u0, u1, u2
