"""The int16 bounce's dither, as the port's K5 bounce defines it:

    q = clip(floor(x * 32767 + u), -32768, 32767)

with u from Philox4x32-10 (Salmon et al., SC'11), key (seed, 0),
counter (i // 4 low word, i // 4 high word, 0, 0) for flat element i,
word i % 4 of the output, u = (word >> 8) * 2**-24; a NaN sample counts
as 0.0.  A NumPy copy: unsigned 64-bit products of 32-bit words are exact.
"""

from __future__ import annotations

import numpy as np

_MASK = np.uint64(0xFFFFFFFF)
_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 over uint64 arrays holding 32-bit words."""
    s32 = np.uint64(32)
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _W0) & 0xFFFFFFFF
            k1 = (k1 + _W1) & 0xFFFFFFFF
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = ((p1 >> s32) ^ c1 ^ np.uint64(k0), p1 & _MASK,
                          (p0 >> s32) ^ c3 ^ np.uint64(k1), p0 & _MASK)
    return c0, c1, c2, c3


def uniforms(offset: int, numel: int, seed: int) -> np.ndarray:
    """u of flat elements offset .. offset + numel - 1, float64 in [0, 1)."""
    first, last = offset // 4, (offset + numel - 1) // 4
    g = np.arange(first, last + 1, dtype=np.uint64)
    zero = np.zeros_like(g)
    words = philox4x32(g & _MASK, g >> np.uint64(32), zero, zero,
                       seed & 0xFFFFFFFF, 0)
    r = np.stack(words, axis=1).reshape(-1)
    start = offset - 4 * first
    r = r[start:start + numel]
    return (r >> np.uint64(8)).astype(np.float64) * 2.0 ** -24


def dither_i16(x: np.ndarray, seed: int, offset: int) -> np.ndarray:
    """int16 codes of x (any shape), x's first element at flat `offset`."""
    x = np.nan_to_num(np.asarray(x, np.float64), nan=0.0, posinf=np.inf,
                      neginf=-np.inf)
    u = uniforms(offset, x.size, seed).reshape(x.shape)
    q = np.floor(x * 32767.0 + u)
    return np.clip(q, -32768.0, 32767.0).astype(np.int16)
