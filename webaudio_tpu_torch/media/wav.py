"""WAV (RIFF) encoding, host-side.

Ported from `webaudio_tpu/media/wav.py::write_wav` (the analog of the
reference's hound-based encode, media_recorder/mod.rs:40-48).  Decoding
needs the native host runtime and waits for its slice of the port.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..constants import NotSupportedError


def write_wav(path_or_file, data, sample_rate: float, bits: int = 32,
              dither: bool = False) -> bytes | None:
    """Encode (channels, frames) audio as WAV: float32 by default, or i16.

    `data` is an array-like or a tensor on any device.  `dither=True`
    quantizes to 16 bits with the port's RPDF dither
    (ops/dither.py::dither_to_i16, the CUDA kernel for a tensor on the
    card); without it the samples are clipped and rounded."""
    if isinstance(data, torch.Tensor):
        data = data.detach()
    else:
        data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    channels, frames = data.shape

    if bits == 16 and dither:
        from ..ops.dither import dither_to_i16

        # a tensor is quantized on its own device; only the codes come back
        fmt_tag = 1
        codes = dither_to_i16(data)
        if isinstance(codes, torch.Tensor):
            codes = codes.cpu().numpy()
        payload = np.asarray(codes, "<i2").T.reshape(-1).tobytes()
    else:
        if isinstance(data, torch.Tensor):
            data = data.cpu().numpy()
        data = np.asarray(data, dtype=np.float32)
        if bits == 32:
            fmt_tag = 3
            payload = data.T.reshape(-1).astype("<f4").tobytes()
        elif bits == 16:
            fmt_tag = 1
            clipped = np.clip(data.T.reshape(-1), -1.0, 1.0)
            payload = (clipped * 32767.0).round().astype("<i2").tobytes()
        else:
            raise NotSupportedError(f"unsupported write bit depth {bits}")

    block_align = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_tag, channels,
                                 int(sample_rate),
                                 int(sample_rate) * block_align,
                                 block_align, bits)
    hdr += b"data" + struct.pack("<I", len(payload))
    blob = hdr + payload
    if path_or_file is None:
        return blob
    if hasattr(path_or_file, "write"):
        path_or_file.write(blob)
    else:
        with open(path_or_file, "wb") as f:
            f.write(blob)
    return None
