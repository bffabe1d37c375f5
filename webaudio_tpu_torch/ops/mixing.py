"""Channel up/down-mixing as pure tensor functions.

The reference performs speaker-layout aware up/down mixing per render
quantum with copy-on-write channel vectors (reference:
src/render/quantum.rs:285-535).  Here the same rules are expressed as pure
functions over `(..., channels, frames)` f32 tensors (an optional leading
instance axis rides along).  For the enumerated speaker
layouts the mix is a constant matrix multiply; everything else is
silence-padding / truncation.  Ported from `webaudio_tpu/ops/mixing.py`:
`mix_matrix` stays numpy, `mix` and `sum_inputs` take torch tensors.
"""

from __future__ import annotations

import functools
from enum import Enum

import numpy as np
import torch


class ChannelInterpretation(str, Enum):
    """reference: src/node/audio_node.rs:35-38"""

    SPEAKERS = "speakers"
    DISCRETE = "discrete"


class ChannelCountMode(str, Enum):
    """reference: src/node/audio_node.rs:9-18"""

    MAX = "max"
    CLAMPED_MAX = "clamped-max"
    EXPLICIT = "explicit"


_SQRT05 = float(np.sqrt(0.5))


@functools.lru_cache(maxsize=None)
def mix_matrix(c_in: int, c_out: int, interpretation: ChannelInterpretation) -> np.ndarray:
    """Return the (c_out, c_in) mixing matrix implementing the spec rules.

    Speaker layouts are only defined for 1/2/4/6 channels and <= 6 channels;
    everything else (and ``discrete``) pads with silence / truncates
    (reference: src/render/quantum.rs:296-306).
    """
    m = np.zeros((c_out, c_in), dtype=np.float32)

    def identity_fill():
        for i in range(min(c_in, c_out)):
            m[i, i] = 1.0

    if interpretation == ChannelInterpretation.DISCRETE or c_in > 6 or c_out > 6:
        identity_fill()
        return m

    pair = (c_in, c_out)
    # --- UP MIX (reference: quantum.rs:309-384) ---
    if pair == (1, 2):
        m[0, 0] = 1.0
        m[1, 0] = 1.0
    elif pair == (1, 4):
        m[0, 0] = 1.0
        m[1, 0] = 1.0
    elif pair == (1, 6):
        m[2, 0] = 1.0  # center
    elif pair == (2, 4):
        m[0, 0] = 1.0
        m[1, 1] = 1.0
    elif pair == (2, 6):
        m[0, 0] = 1.0
        m[1, 1] = 1.0
    elif pair == (4, 5):
        # L R C=0 SL SR  (reference: quantum.rs:360-369)
        m[0, 0] = 1.0
        m[1, 1] = 1.0
        m[3, 2] = 1.0
        m[4, 3] = 1.0
    elif pair == (4, 6):
        m[0, 0] = 1.0
        m[1, 1] = 1.0
        m[4, 2] = 1.0
        m[5, 3] = 1.0
    # --- DOWN MIX (reference: quantum.rs:385-500) ---
    elif pair == (2, 1):
        m[0, 0] = 0.5
        m[0, 1] = 0.5
    elif pair == (4, 1):
        m[0, :] = 0.25
    elif pair == (6, 1):
        # sqrt(0.5)*(L+R) + C + 0.5*(SL+SR); LFE dropped
        m[0, 0] = _SQRT05
        m[0, 1] = _SQRT05
        m[0, 2] = 1.0
        m[0, 4] = 0.5
        m[0, 5] = 0.5
    elif pair == (4, 2):
        m[0, 0] = 0.5
        m[0, 2] = 0.5
        m[1, 1] = 0.5
        m[1, 3] = 0.5
    elif pair == (6, 2):
        m[0, 0] = 1.0
        m[0, 2] = _SQRT05
        m[0, 4] = _SQRT05
        m[1, 1] = 1.0
        m[1, 2] = _SQRT05
        m[1, 5] = _SQRT05
    elif pair == (6, 4):
        m[0, 0] = 1.0
        m[0, 2] = _SQRT05
        m[1, 1] = 1.0
        m[1, 2] = _SQRT05
        m[2, 4] = 1.0
        m[3, 5] = 1.0
    else:
        # all other combinations: silence-pad / truncate
        # (reference: quantum.rs:501-511)
        identity_fill()
    return m


def mix(signal: torch.Tensor, c_out: int,
        interpretation: ChannelInterpretation) -> torch.Tensor:
    """Mix a `(..., c_in, frames)` signal to `c_out` channels.

    Identity and silence-pad cases avoid the matmul; the general case is a
    small constant matmul on the signal's device.
    """
    c_in = signal.shape[-2]
    if c_in == c_out:
        return signal
    m = mix_matrix(c_in, c_out, interpretation)
    # Fast paths for pure selection matrices (padding / truncation / dup).
    if c_out < c_in and np.array_equal(m, np.eye(c_out, c_in, dtype=np.float32)):
        return signal[..., :c_out, :]
    if c_out > c_in and np.array_equal(m, np.eye(c_out, c_in, dtype=np.float32)):
        pad = signal.new_zeros(signal.shape[:-2] + (c_out - c_in, signal.shape[-1]))
        return torch.cat([signal, pad], dim=-2)
    if (c_in, c_out) == (1, 2) and interpretation == ChannelInterpretation.SPEAKERS:
        return torch.cat([signal, signal], dim=-2)
    return _matrix_on(c_in, c_out, interpretation, signal.device) @ signal


@functools.lru_cache(maxsize=None)
def _matrix_on(c_in: int, c_out: int, interpretation: ChannelInterpretation,
               device: torch.device) -> torch.Tensor:
    """The mix matrix on `device`, staged at its first use (an eager
    block) and reused, so a captured walk uploads nothing."""
    return torch.from_numpy(mix_matrix(c_in, c_out, interpretation)).to(device)


def computed_number_of_channels(
    mode: ChannelCountMode, channel_count: int, max_input_channels: int
) -> int:
    """Computed channel count of a node input per the spec.

    reference: src/render/graph.rs:524-535 feeding quantum.rs:260-283.
    An unconnected / silent input counts as 1 channel.
    """
    max_input_channels = max(1, max_input_channels)
    if mode == ChannelCountMode.MAX:
        return max_input_channels
    if mode == ChannelCountMode.CLAMPED_MAX:
        return min(max_input_channels, channel_count)
    return channel_count


def sum_inputs(
    signals: list[torch.Tensor],
    c_out: int,
    interpretation: ChannelInterpretation,
    frames: int,
    device: torch.device | str,
    batch: int | None = None,
) -> torch.Tensor:
    """Fan-in: mix each incoming signal to ``c_out`` then sum.  An input
    with no signals is f32 silence on `device`, shaped (c_out, frames), or
    (batch, c_out, frames) when `batch` is given.

    reference: src/render/quantum.rs:532-569 (`AudioRenderQuantum::add`).
    """
    if not signals:
        lead = () if batch is None else (batch,)
        return torch.zeros(lead + (c_out, frames), dtype=torch.float32,
                           device=device)
    acc = mix(signals[0], c_out, interpretation)
    for s in signals[1:]:
        acc = acc + mix(s, c_out, interpretation)
    return acc
