"""webaudio_tpu_torch — the Web Audio engine on PyTorch and CUDA.

A port of `webaudio_tpu` (JAX) to PyTorch, for NVIDIA Hopper GPUs:

- a graph's topology is planned once per suspend segment and rendered in
  large blocks by a Python loop, with functional per-node state carried
  from block to block;
- AudioParam automation timelines are precompiled on the host into dense
  rows or constants;
- LTI biquads run as truncated-IR partitioned FFT convolutions
  (`torch.fft`), automated biquads as f64 log-depth scans;
- banks of same-buffer sources fuse into one node, grain clouds into a
  few lanes (`graph/fusion.py`);
- kernels that the JAX package wrote in Pallas for the TPU are hand-written
  CUDA kernels here (`csrc/`), built with `nvcc` at first use; on CPU
  tensors their plain PyTorch versions run instead.

The public API mirrors the JAX package: `OfflineAudioContext(channels,
length, sample_rate, device="cuda")`, the `create_*` factories, `connect`,
`start`, AudioParam automation, `suspend_sync` and `start_rendering_sync`
(or `start_rendering`, `suspend` and `resume` as futures);
`GraphBatch` and `MixedGraphBatch` render many graphs in one block walk,
with dithered int16 and u-law bounces on the device, or split over the
devices of a `parallel.mesh.Mesh`; `RenderSession` renders in resumable
steps with checkpoints, `render_time_sharded` in time segments, and `AudioWorkletNode` / `ScriptProcessorNode` run user
code.  `AudioContext(device="cuda")` renders in real time into a sink
(callback, WAV file, null), and `decode_audio_data` / the media nodes,
streams, recorder and element bring audio in and out through the host.
This package never imports `jax` or `webaudio_tpu`.
"""

from .constants import (  # noqa: F401
    RENDER_QUANTUM_SIZE, MAX_CHANNELS,
    WebAudioError, NotSupportedError, IndexSizeError, InvalidStateError,
    InvalidAccessError, RangeError,
)
from .buffer import AudioBuffer  # noqa: F401
from .param import AudioParam, AudioParamDescriptor, AutomationRate  # noqa: F401
from .periodic_wave import PeriodicWave  # noqa: F401
from .ops.cuda_lib import KernelError  # noqa: F401
from .ops.mixing import ChannelCountMode, ChannelInterpretation  # noqa: F401
from .context.base import BaseAudioContext, AudioContextState  # noqa: F401
from .context.offline import OfflineAudioContext  # noqa: F401
from .parallel.batch import GraphBatch, MixedGraphBatch  # noqa: F401

__version__ = "0.1.0"

_LAZY = {
    "AudioContext": ("webaudio_tpu_torch.context.online", "AudioContext"),
    "AudioContextOptions": ("webaudio_tpu_torch.context.online",
                            "AudioContextOptions"),
    "MediaStream": ("webaudio_tpu_torch.media.streams", "MediaStream"),
    "MediaStreamTrack": ("webaudio_tpu_torch.media.streams",
                         "MediaStreamTrack"),
    "MediaRecorder": ("webaudio_tpu_torch.media.recorder", "MediaRecorder"),
    "MediaElement": ("webaudio_tpu_torch.media.element", "MediaElement"),
    "MediaDecoder": ("webaudio_tpu_torch.media.decoding", "MediaDecoder"),
    "enumerate_devices_sync": ("webaudio_tpu_torch.media.devices",
                               "enumerate_devices_sync"),
    "get_user_media_sync": ("webaudio_tpu_torch.media.devices",
                            "get_user_media_sync"),
    "MediaTrackConstraints": ("webaudio_tpu_torch.media.devices",
                              "MediaTrackConstraints"),
    "MediaDeviceInfo": ("webaudio_tpu_torch.media.devices",
                        "MediaDeviceInfo"),
    "AudioRenderCapacityEvent": ("webaudio_tpu_torch.stats",
                                 "AudioRenderCapacityEvent"),
    "AudioWorkletNode": ("webaudio_tpu_torch.worklet", "AudioWorkletNode"),
    "AudioWorkletProcessor": ("webaudio_tpu_torch.worklet",
                              "AudioWorkletProcessor"),
    "MessagePort": ("webaudio_tpu_torch.worklet", "MessagePort"),
    "render_time_sharded": ("webaudio_tpu_torch.parallel.segments",
                            "render_time_sharded"),
    "RenderSession": ("webaudio_tpu_torch.checkpoint", "RenderSession"),
    "EventType": ("webaudio_tpu_torch.events", "EventType"),
    "OscillatorBankNode": ("webaudio_tpu_torch.nodes.oscillator_bank",
                           "OscillatorBankNode"),
}


def __getattr__(name):
    # lazy imports for the online context, media I/O, session, segment,
    # user-code, event and voice-bank modules
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
