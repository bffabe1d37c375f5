"""Rounding to a stated precision, applied after each operation of a
reference render.  float64 leaves values as they are; float32,
tfloat32 (float32's range, 10 bits of mantissa, as the tensor cores
take float32 operands), float16 and bfloat16 round to nearest even, as
a device does after each operation (a bfloat16 product accumulates in
float32, so one rounding an operation is what bfloat16 arithmetic
gives)."""

from __future__ import annotations

import numpy as np


def _keep_bits(x, drop):
    """float32 with its lowest `drop` mantissa bits rounded off."""
    a = np.asarray(x, np.float64).astype(np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    u = (u + half + ((u >> drop) & 1)) & (0xFFFFFFFF ^ ((1 << drop) - 1))
    out = u.astype(np.uint32).view(np.float32)
    out = np.where(np.isfinite(a), out, a)
    return out.astype(np.float64)


def _bf16(x):
    return _keep_bits(x, 16)


def _tf32(x):
    return _keep_bits(x, 13)


def _f16(x):
    return np.asarray(x, np.float64).astype(np.float16).astype(np.float64)


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def _f64(x):
    return np.asarray(x, np.float64)


def rounder(name: str):
    """The rounding function of `name`: float64, float32, tfloat32,
    float16 or bfloat16."""
    try:
        return {"float64": _f64, "float32": _f32, "tfloat32": _tf32,
                "float16": _f16, "bfloat16": _bf16}[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r}") from None
