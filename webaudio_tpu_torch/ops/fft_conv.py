"""Uniform partitioned FFT convolution (frequency-domain delay line).

reference: the `fft-convolver` crate used by ConvolverNode
(convolver.rs:286-307).  Overlap-save with partition P: the IR is
pre-transformed host-side into a (C_ir, K, P+1) complex64 spectrum matrix
staged to the device once; per render block the engine computes B/P
input-chunk spectra with one batched `torch.fft.rfft`, performs the
partition multiply-accumulate

    Y[j] = sum_k H[k] * X[j - k]

and one batched `torch.fft.irfft`.  The delay line (last K-1 chunk spectra
+ P input tail samples) is carried in the block state.  Ported from
`webaudio_tpu/ops/fft_conv.py`: `choose_partition` and `partition_ir` stay
host numpy, `partitioned_conv_block` takes torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_PARTITION = 1024   # reference: convolver.rs:286
MAX_PARTITION = 16384      # one partition per 128-quanta block


def choose_partition(block_frames: int) -> int:
    """Largest power-of-two divisor of the block size, capped at
    MAX_PARTITION.  The partitioned-convolution output is exact for any
    partition, and a larger one is cheaper: the per-sample MAC cost scales
    with K = ceil(ir_len/P) while the FFT cost grows logarithmically.
    Blocks are multiples of the render quantum (128), so the result is in
    [128, MAX_PARTITION]."""
    p = block_frames & (-block_frames)
    return min(p, MAX_PARTITION)


def partition_ir(ir: np.ndarray, partition: int = DEFAULT_PARTITION) -> np.ndarray:
    """IR (C_ir, L) or (L,) -> spectra (C_ir, K, P+1) complex64 (host-side)."""
    ir = np.asarray(ir, dtype=np.float32)
    if ir.ndim == 1:
        ir = ir[None, :]
    c, L = ir.shape
    P = partition
    K = max(1, -(-L // P))
    padded = np.zeros((c, K * P), np.float32)
    padded[:, :L] = ir
    chunks = padded.reshape(c, K, P)
    # zero-pad to 2P for linear (not circular) convolution
    z = np.zeros((c, K, 2 * P), np.float32)
    z[:, :, :P] = chunks
    return np.fft.rfft(z, axis=-1).astype(np.complex64)


def init_state(channels: int, k_partitions: int, partition: int,
               device) -> dict:
    """Zero delay line: {"spectra": (C, K-1, P+1) c64, "tail": (C, P) f32}."""
    P = partition
    return {
        "spectra": torch.zeros((channels, max(k_partitions - 1, 0), P + 1),
                               dtype=torch.complex64, device=device),
        "tail": torch.zeros((channels, P), dtype=torch.float32, device=device),
    }


def partitioned_conv_block(state, x, h_spectra, partition: int):
    """Convolve one block through the frequency-domain delay line.

    state: {"spectra": (..., C, K-1, P+1) c64, "tail": (..., C, P) f32}
    x: (..., C, B) f32 with B a multiple of P; the leading axes (an
    instance axis) ride along
    h_spectra: (..., C_h, K, P+1) complex64, broadcast against x's leading
    axes and channels (C_h is C or 1; a leading axis is N or 1)

    Returns (new_state, y (..., C, B) f32).
    """
    lead = x.shape[:-1]                                       # (..., C)
    B = x.shape[-1]
    P = partition
    J = B // P
    K = h_spectra.shape[-2]

    # overlap-save segments: for chunk j, fft of [prev P samples, chunk]
    ext = torch.cat([state["tail"], x], dim=-1)               # (..., C, B + P)
    segs = torch.stack([ext[..., : J * P].reshape(lead + (J, P)),
                        ext[..., P:].reshape(lead + (J, P))],
                       dim=-2).reshape(lead + (J, 2 * P))
    X = torch.fft.rfft(segs, dim=-1)                          # (..., C, J, P+1)

    # delay line: past K-1 spectra followed by this block's J spectra
    Xfull = torch.cat([state["spectra"], X], dim=-2)          # (..., C, K-1+J, P+1)

    # Y[j] = sum_k H[k] * Xfull[j + K-1 - k]
    if K * J <= 512:
        # J*K elementwise MACs over static slices: the windowed
        # (..., C, J, K, P+1) intermediate is never materialized
        Y = None
        for k in range(K):
            term = h_spectra[..., k, None, :] * \
                Xfull[..., K - 1 - k: K - 1 - k + J, :]
            Y = term if Y is None else Y + term
    else:
        jj = torch.arange(J, device=x.device)[:, None]
        kk = torch.arange(K, device=x.device)[None, :]
        win = Xfull[..., jj + (K - 1) - kk, :]                # (..., C, J, K, P+1)
        Y = torch.einsum("...jkf,...kf->...jf", win, h_spectra)

    y = torch.fft.irfft(Y, n=2 * P, dim=-1)[..., P:]          # overlap-save
    y = y.reshape(lead + (B,)).to(torch.float32)

    new_state = {
        "spectra": Xfull[..., Xfull.shape[-2] - (K - 1):, :] if K > 1
        else state["spectra"],
        "tail": ext[..., B:],
    }
    return new_state, y
