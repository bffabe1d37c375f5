"""Media source/destination nodes: bridge streams into/out of the graph.

reference: src/node/media_stream_source.rs, media_stream_track_source.rs,
media_element_source.rs, media_stream_destination.rs and the shared
MediaStreamRenderer (src/node/mod.rs:60-113).  Ported from
`webaudio_tpu/nodes/media_nodes.py`, whose kernels reach the host through
`jax.pure_callback` and `io_callback` inside the compiled scan.  The
port's block walk is a Python loop, so the host calls are plain calls:

- a source's kernel pulls one block from its host stream and makes one
  upload a block (`torch.from_numpy(...).to(device)`);
- the destination makes one device-to-host copy a block (`.cpu()`) and
  pushes it into a live PushStreamTrack.

In a GraphBatch the instances pull (and push) in turn, lane 0 first, as
the JAX package's `vmap_method="sequential"` does.  Each node counts its
transfers in `uploads` / `host_copies`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buffer import AudioBuffer
from ..graph.compiler import Kernel
from ..media.resampler import Resampler
from ..media.streams import MediaStream, MediaStreamTrack, PushStreamTrack
from .audio_node import AudioNode


class _HostPullKernel(Kernel):
    """Pull (channels, B) from the host per block and instance, then one
    upload of the (N, channels, B) block to the render device."""

    def __init__(self, node, pull, device):
        self.node = node
        self.pull = pull        # frames -> (channels, frames) f32 numpy
        self.device = device

    def process(self, scope, state, inputs, params):
        host = np.stack([self.pull(scope.frames) for _ in range(scope.n)])
        self.node.uploads += 1
        return state, [torch.from_numpy(host).to(self.device)]


class _StreamSourceBase(AudioNode):
    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, context, track: MediaStreamTrack,
                 channels_hint: int = 2):
        super().__init__(context)
        self._resampler = Resampler(
            _track_chunks(track), context.sample_rate)
        self._channels = channels_hint
        self._track = track
        self.uploads = 0

    def _next_quantum(self):
        try:
            buf = next(self._resampler)
        except StopIteration:
            return None
        return buf.to_array()

    def _pull_host(self, frames: int) -> np.ndarray:
        """The MediaStreamRenderer analog (node/mod.rs:60-113): whole
        quanta from the re-chunked stream, silence once it has ended."""
        out = np.zeros((self._channels, frames), np.float32)
        filled = 0
        while filled < frames:
            chunk = self._next_quantum()
            if chunk is None:
                break
            n = min(chunk.shape[1], frames - filled)
            c = min(chunk.shape[0], self._channels)
            out[:c, filled:filled + n] = chunk[:c, :n]
            filled += n
        return out

    def output_channel_count(self, input_counts):
        return [self._channels]

    def make_kernel(self, render_ctx):
        return _HostPullKernel(self, self._pull_host, render_ctx.device)

    def block_constraint(self):
        return None


def _track_chunks(track: MediaStreamTrack):
    while True:
        chunk = track.next_chunk()
        if chunk is None:
            return
        yield chunk


class MediaStreamAudioSourceNode(_StreamSourceBase):
    """reference: media_stream_source.rs."""

    def __init__(self, context, stream: MediaStream):
        tracks = stream.get_audio_tracks()
        if not tracks:
            raise ValueError("MediaStream has no audio tracks")
        super().__init__(context, tracks[0])


class MediaStreamTrackAudioSourceNode(_StreamSourceBase):
    """reference: media_stream_track_source.rs."""

    def __init__(self, context, track: MediaStreamTrack):
        super().__init__(context, track)


class MediaElementAudioSourceNode(AudioNode):
    """reference: media_element_source.rs (pulls from MediaElement controls
    honoring pause/seek/rate/loop live)."""

    _number_of_inputs = 0
    _number_of_outputs = 1

    def __init__(self, context, media_element):
        super().__init__(context)
        self.media_element = media_element
        self._channels = media_element.number_of_channels
        self.uploads = 0

    def output_channel_count(self, input_counts):
        return [self._channels]

    def make_kernel(self, render_ctx):
        rate = render_ctx.sample_rate
        return _HostPullKernel(
            self, lambda frames: self.media_element._pull_chunk(frames, rate),
            render_ctx.device)


class _PushKernel(Kernel):
    def __init__(self, node):
        self.node = node

    def process(self, scope, state, inputs, params):
        x = inputs[0]                       # (N, C, B)
        host = x.cpu().numpy()
        self.node.host_copies += 1
        for lane in host:
            self.node._push_host(lane)
        return state, [x]


class MediaStreamAudioDestinationNode(AudioNode):
    """reference: media_stream_destination.rs:119+ — captures its input as
    a new MediaStream."""

    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context):
        super().__init__(context)
        self._track = PushStreamTrack(label="graph-capture")
        self.stream = MediaStream([self._track])
        self._sample_rate = context.sample_rate
        self.host_copies = 0

    def _push_host(self, chunk: np.ndarray):
        self._track.push(AudioBuffer.from_array(chunk, self._sample_rate))

    def output_channel_count(self, input_counts):
        return [max(1, input_counts[0])]

    def make_kernel(self, render_ctx):
        return _PushKernel(self)
