"""Dithered 16-bit and 8-bit u-law bounces: the CUDA kernels and their plain
versions.

Ports the TPU kernels K5 (`webaudio_tpu/ops/dither.py::dither_to_i16_tpu`,
body `_dither_kernel`) and K6 (`ulaw_to_u8_tpu`, body `_ulaw_kernel`):

    K5  q = clip(floor(x * 32767 + u), -32768, 32767)              -> int16
    K6  x = clip(x, -1, 1);  y = sign(x) * log1p(255 |x|) / ln 256
        q = clip(floor((y * 0.5 + 0.5) * 255 + u), 0, 255)           -> uint8

with u uniform in [0, 1): 1-LSB RPDF dither, i.e. stochastic rounding.
The TPU drew u from its on-core generator, whose bits cannot be
reproduced elsewhere.  Here u comes from Philox4x32-10 (Salmon et al.,
SC'11) with key (seed, 0) and counter (i // 4, 0, 0, 0) for flat element
index i (the counter's second word takes the bits of i // 4 above 32):
element i takes word i % 4 of its counter's output r, and
u = (r >> 8) * 2**-24, which is exact in f32.  The stream depends on the
seed and the element index only, never on the launch geometry, so the
kernel (`csrc/quantize.cu`) and the plain versions below, which compute
the same Philox with int64 tensor ops, give the same codes.  Every entry
takes `offset`, the flat index of x's first element in a larger tensor (a
multiple of 4): a batch bounced shard by shard, each shard with its own
offset, gets the codes of one bounce of the whole batch.

What JAX leaves undefined is defined here: a NaN sample is quantized as
0.0 (with its own u), and +-inf clip to the end codes.

`dither_i16` and `ulaw_u8` launch the kernels for CUDA tensors and raise
`KernelError` for anything they cannot take; they run the plain versions
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_lib import KernelError, check, load_library

_SOURCE = "quantize.cu"

_MASK = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MU = 255.0
# the f32 constant the JAX kernel multiplies by (dither.py:104)
_INV_LOG = float(np.float32(1.0 / np.log(1.0 + _MU)))


def philox4x32(counter, key):
    """Philox4x32-10 over int64 tensors holding u32 words.

    counter: four int64 tensors of one shape, each word in [0, 2**32);
    key: two Python ints in [0, 2**32).  Returns the four output words as
    int64 tensors.  A u32 product overflows signed int64, but its low 64
    bits are still right modulo 2**64, so the high word is
    (p >> 32) & 0xFFFFFFFF."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W0) & _MASK
            k1 = (k1 + _PHILOX_W1) & _MASK
        p0 = c0 * _PHILOX_M0
        p1 = c2 * _PHILOX_M1
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK) ^ c1 ^ k0, p1 & _MASK,
                          ((p0 >> 32) & _MASK) ^ c3 ^ k1, p0 & _MASK)
    return c0, c1, c2, c3


def _check_offset(name, offset):
    if offset < 0 or offset % 4:
        raise ValueError(f"{name}: offset {offset} is not a non-negative "
                         "multiple of 4")


def uniforms(numel: int, seed: int, device, offset: int = 0) -> torch.Tensor:
    """The kernels' u for flat elements offset..offset+numel-1: (numel,)
    f32 in [0, 1)."""
    _check_offset("uniforms", offset)
    groups = -(-numel // 4)
    g = torch.arange(offset // 4, offset // 4 + groups, dtype=torch.int64,
                     device=device)
    zero = torch.zeros_like(g)
    words = philox4x32((g & _MASK, g >> 32, zero, zero), (seed & _MASK, 0))
    r = torch.stack(words, dim=1).reshape(-1)[:numel]
    return (r >> 8).to(torch.float32) * 2.0 ** -24


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def dither_i16_reference(x: torch.Tensor, seed: int,
                         offset: int = 0) -> torch.Tensor:
    """Plain version of K5: f32 x of any shape -> int16 codes."""
    u = uniforms(x.numel(), seed, x.device, offset).reshape(x.shape)
    q = torch.floor(_finite_or_zero(x) * 32767.0 + u)
    return torch.clamp(q, -32768.0, 32767.0).to(torch.int16)


def ulaw_u8_reference(x: torch.Tensor, seed: int,
                      offset: int = 0) -> torch.Tensor:
    """Plain version of K6: f32 x of any shape -> uint8 u-law codes."""
    u = uniforms(x.numel(), seed, x.device, offset).reshape(x.shape)
    x = torch.clamp(_finite_or_zero(x), -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(_MU * torch.abs(x)) * _INV_LOG
    q = torch.floor((y * 0.5 + 0.5) * 255.0 + u)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8)


@functools.cache
def _launchers():
    lib = load_library(_SOURCE)
    fns = {}
    for name in ("dither_i16", "ulaw_u8"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_uint32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _quantize(wrapper, reference, out_dtype, x, seed, out, offset):
    name = wrapper.__name__
    _check_offset(name, offset)
    if x.device.type == "cpu" and (out is None or out.device.type == "cpu"):
        codes = reference(x, seed, offset)
        return codes if out is None else out.copy_(codes)
    if out is None:
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.device.type != "cuda" or out.device != x.device:
        raise KernelError(f"{name}: x on {x.device}, out on {out.device}; "
                          "both must lie on the same CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise KernelError(f"{name}: x is not on the current device")
    if x.dtype != torch.float32 or out.dtype != out_dtype:
        raise KernelError(f"{name}: needs f32 x and {out_dtype} out, got "
                          f"{x.dtype} and {out.dtype}")
    if out.shape != x.shape:
        raise KernelError(f"{name}: out {tuple(out.shape)} is not shaped like "
                          f"x {tuple(x.shape)}")
    if not (x.is_contiguous() and out.is_contiguous()):
        raise KernelError(f"{name}: x and out must be contiguous")
    rc = _launchers()[name](x.data_ptr(), out.data_ptr(), x.numel(), offset,
                            seed & _MASK,
                            torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, f"{name} launch")
    wrapper.launches += 1
    return out


def dither_i16(x: torch.Tensor, seed: int = 0, out=None,
               offset: int = 0) -> torch.Tensor:
    """Dithered int16 codes of f32 x.  CUDA tensors go through the
    hand-written kernel (each launch adds one to `dither_i16.launches`);
    CPU tensors take `dither_i16_reference`.  `out`, if given, receives
    the codes and must lie on x's device; `offset` is x[0]'s flat index in
    the stream (a multiple of 4)."""
    return _quantize(dither_i16, dither_i16_reference, torch.int16, x, seed,
                     out, offset)


def ulaw_u8(x: torch.Tensor, seed: int = 0, out=None,
            offset: int = 0) -> torch.Tensor:
    """Dithered 8-bit u-law codes of f32 x; launches as `dither_i16`
    does (counted in `ulaw_u8.launches`)."""
    return _quantize(ulaw_u8, ulaw_u8_reference, torch.uint8, x, seed, out,
                     offset)


dither_i16.launches = 0
ulaw_u8.launches = 0


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous(), True
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)), False


def dither_to_i16(x, seed: int = 0):
    """Dithered int16 quantization of x (a tensor on any device, or
    array-like).  A tensor comes back as an int16 tensor on its device; an
    array as an int16 numpy array."""
    t, is_tensor = _as_tensor(x)
    codes = dither_i16(t, seed)
    return codes if is_tensor else codes.numpy()


def ulaw_encode_u8(x, seed: int = 0):
    """u-law companded, dithered 8-bit codes of x; tensors and arrays as in
    `dither_to_i16`."""
    t, is_tensor = _as_tensor(x)
    codes = ulaw_u8(t, seed)
    return codes if is_tensor else codes.numpy()


def ulaw_decode_u8(codes) -> np.ndarray:
    """Expand u8 u-law codes back to f32 (host-side consumer step).

    The encoder stochastically rounds with E[code] = scaled value, so the
    unbiased inverse is codes/255 (a +0.5-LSB shift would bias every
    sample and expand code 255 past full scale); output clips to [-1, 1]
    like the encoder's input domain."""
    y = np.asarray(codes, np.float32) / 255.0 * 2.0 - 1.0
    out = (np.sign(y) * (np.power(1.0 + _MU, np.abs(y)) - 1.0) / _MU)
    return np.clip(out, -1.0, 1.0).astype(np.float32)
