"""AudioWorklet: user-defined audio processors.

reference: src/worklet.rs.  The reference's `AudioWorkletProcessor` trait
(constructor options, `parameter_descriptors()`, `process(inputs, outputs,
params, scope) -> bool`, worklet.rs:50-114) maps onto the engine's
functional kernel protocol: a processor declares params and implements

    init_state(render_ctx) -> tree of tensors (or None)
    process(scope, state, inputs, params) -> (state', outputs)

in PyTorch, for ONE instance of the graph: `inputs` a list of (C, B) f32
tensors, `params` a dict of 0-d (constant over the render) or (B,) f32
tensors, `outputs` a list of (C_out, B) tensors.  `scope` is a
`WorkletScope`; its `frame0` is a 0-d int64 tensor on the render device
(do arithmetic on it there), `t_idx` the block's (B,) int64 sample
indices, `frames`, `sample_rate` and `dt` plain numbers.  `render_ctx`
holds `input_channel_counts`, `sample_rate`, `block_frames` and `device`;
the state's tensors belong on `render_ctx.device` (they are moved there if
they are not).

The block walk renders N instances at once.  With N = 1 the processor sees
its instance directly; with N > 1 its `process` runs under
`torch.func.vmap` over the instance axis (the analog of the JAX package's
`vmap`), or, where it cannot be vmapped (data-dependent Python control
flow, `.item()`), once per instance in a loop.  Either way an error the
processor raises fails the node as the reference isolates it: its outputs
go silent and `onprocessorerror` fires.  User code may read the host
and branch on device values, so a plan with a worklet walks eagerly on the
card and is never captured as a CUDA graph (`CompiledGraph.capture` names
the node).

MessagePort messaging is control-side and takes effect at plan boundaries
(construction, suspend re-plans), mirroring how the reference delivers
messages between render quanta (worklet.rs:301-321).  Ported from
`webaudio_tpu/worklet.py`.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import torch

from .constants import IndexSizeError, NotSupportedError
from .convert import tree_map
from .graph.compiler import Kernel
from .nodes.audio_node import AudioNode, AudioNodeOptions
from .param import AudioParamDescriptor


class MessagePort:
    """Bidirectional control<->processor channel
    (reference: src/message_port.rs:1-54)."""

    def __init__(self):
        self._onmessage: Optional[Callable] = None
        self._peer: Optional["MessagePort"] = None
        self._pending: list = []

    @staticmethod
    def pair() -> tuple["MessagePort", "MessagePort"]:
        a, b = MessagePort(), MessagePort()
        a._peer, b._peer = b, a
        return a, b

    def set_onmessage(self, cb: Callable):
        self._onmessage = cb
        # deliver anything posted before a handler existed (the reference's
        # channel buffers messages until the render thread drains them,
        # worklet.rs onmessage / message_port.rs) — with lazy processor
        # construction the node may post before the processor exists
        pending, self._pending = self._pending, []
        for msg in pending:
            cb(msg)

    def post_message(self, msg: Any):
        if self._peer is None:
            return
        if self._peer._onmessage is not None:
            self._peer._onmessage(msg)
        else:
            self._peer._pending.append(msg)


class AudioWorkletProcessor:
    """Base class for user processors (reference: worklet.rs:50-114)."""

    def __init__(self, options: Optional[dict] = None,
                 port: Optional[MessagePort] = None):
        self.options = options or {}
        self.port = port

    @classmethod
    def parameter_descriptors(cls) -> list[AudioParamDescriptor]:
        return []

    def init_state(self, render_ctx):
        return None

    def process(self, scope, state, inputs, params):
        """Return (state', [outputs]): PyTorch code for one instance, called
        once per block."""
        raise NotImplementedError


class WorkletScope:
    """The block as a processor sees it (the analog of
    AudioWorkletGlobalScope, reference: src/render/processor.rs:20-27):
    `frame0` a 0-d int64 tensor on the render device, `t_idx` the (B,)
    int64 sample indices, `frames`, `sample_rate` and `dt` numbers."""

    __slots__ = ("frame0", "frames", "sample_rate", "dt", "t_idx")

    def __init__(self, frame0: int, frames: int, sample_rate: float, device):
        self.frame0 = torch.tensor(frame0, dtype=torch.int64, device=device)
        self.frames = frames
        self.sample_rate = sample_rate
        self.dt = 1.0 / sample_rate
        self.t_idx = torch.arange(frame0, frame0 + frames, dtype=torch.int64,
                                  device=device)


class _WorkletKernel(Kernel):
    capture_refusal = "runs an AudioWorkletProcessor's user code"

    def __init__(self, processor: AudioWorkletProcessor, rc, n_outputs: int,
                 output_channel_count):
        self.processor = processor
        self.rc = rc
        self.n_outputs = n_outputs
        self.output_channel_count = output_channel_count
        # opt-in per processor class or globally via env (mirrors the
        # reference's cargo feature, off by default)
        self.spec_inputs = bool(
            getattr(processor, "spec_compliant_inputs", False)
            or os.environ.get("WEBAUDIO_SPEC_WORKLET_INPUTS") == "1")
        self.vmap_ok = True      # false once the processor refused vmap

    def init_state(self):
        state = self.processor.init_state(self.rc)
        return tree_map(lambda x: torch.as_tensor(x).to(self.rc.device),
                        state)

    def tail_frames(self):
        # processors may declare a bounded state history to opt in to
        # time-sharded rendering (parallel/segments.py)
        hook = getattr(self.processor, "tail_frames", None)
        return hook() if hook is not None else None

    def _run(self, scope, state, inputs, params):
        """The processor on one instance: (state', [outputs])."""
        state, outputs = self.processor.process(scope, state, inputs, params)
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        return state, [torch.as_tensor(o).to(torch.float32) for o in outputs]

    def process(self, scope, state, inputs, params):
        n = scope.n
        if self.spec_inputs:
            # spec-compliant empty-input distinction (the reference's
            # `spec-compliant-worklet-inputs` feature, worklet.rs:367-385
            # + Cargo.toml:104-107): a DISCONNECTED input port is a
            # zero-channel tensor, a connected-but-silent one stays (C, B)
            # zeros — processors can tell the two apart
            connected = self.rc.input_connected
            inputs = [x if (i < len(connected) and connected[i])
                      else x.new_zeros((n, 0, x.shape[-1]))
                      for i, x in enumerate(inputs)]
        # dense params (N, 1, B) -> (N, B); constants stay shared 0-d
        params = {k: v if v.dim() == 0 else v[:, 0] for k, v in params.items()}
        wscope = WorkletScope(scope.frame0_host, scope.frames,
                              self.rc.sample_rate, scope.device)

        def one(i):
            return self._run(wscope, tree_map(lambda x: x[i], state),
                             [x[i] for x in inputs],
                             {k: v if v.dim() == 0 else v[i]
                              for k, v in params.items()})

        if n == 1:
            st, outs = one(0)
            return (tree_map(lambda x: x.unsqueeze(0), st),
                    [o.unsqueeze(0) for o in outs])
        if self.vmap_ok:
            def run(st, ins, prm):
                st, outs = self._run(wscope, st, ins, prm)
                return ({} if st is None else st), outs

            try:
                st, outs = torch.func.vmap(
                    run, in_dims=({} if state is None else 0, 0,
                                  {k: None if v.dim() == 0 else 0
                                   for k, v in params.items()}))(
                    {} if state is None else state, list(inputs), params)
                return (None if state is None else st), list(outs)
            except RuntimeError:
                # not vmappable (data-dependent control flow, .item()): run
                # it per instance below, where an error of the processor's
                # own raises again and fails the node
                self.vmap_ok = False
        runs = [one(i) for i in range(n)]
        st = None if runs[0][0] is None else _stack([r[0] for r in runs])
        return st, [torch.stack([r[1][j] for r in runs])
                    for j in range(len(runs[0][1]))]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack([torch.as_tensor(t) for t in trees])


class AudioWorkletNode(AudioNode):
    """reference: worklet.rs:125-289."""

    def __init__(self, context, processor_cls, number_of_inputs: int = 1,
                 number_of_outputs: int = 1,
                 output_channel_count: Optional[list[int]] = None,
                 parameter_data: Optional[dict] = None,
                 processor_options: Optional[dict] = None,
                 **options):
        if number_of_inputs == 0 and number_of_outputs == 0:
            raise NotSupportedError(
                "number_of_inputs and number_of_outputs cannot both be zero")
        self._number_of_inputs = int(number_of_inputs)
        self._number_of_outputs = int(number_of_outputs)
        if output_channel_count is not None and len(output_channel_count) == 0:
            # [spec]/reference: an empty sequence means "not specified"
            # (worklet.rs test_worklet_output_channel_count options1)
            output_channel_count = None
        if output_channel_count is not None:
            if len(output_channel_count) != number_of_outputs:
                raise IndexSizeError(
                    "output_channel_count length must equal number_of_outputs")
            for c in output_channel_count:
                if not (1 <= c <= 32):
                    raise NotSupportedError("invalid output channel count")
        self._output_channel_count = output_channel_count
        super().__init__(context,
                         options=AudioNodeOptions(**options) if options else None)

        node_port, proc_port = MessagePort.pair()
        self.port = node_port
        # processor constructed LAZILY at first plan — the analog of the
        # reference constructing it on the render thread at the first
        # quantum (worklet.rs:301-321): node creation never runs user code;
        # a constructor that throws surfaces at plan/render time and is
        # isolated like any processor failure
        self._processor_cls = processor_cls
        self._processor_options = processor_options
        self._proc_port = proc_port
        self._processor = None
        self._parameters: dict[str, Any] = {}
        for desc in processor_cls.parameter_descriptors():
            p = self._register_param(desc.name, desc)
            self._parameters[desc.name] = p
            if parameter_data and desc.name in parameter_data:
                p.set_value(parameter_data[desc.name])

    @property
    def parameters(self) -> dict:
        """Named AudioParam map (reference: worklet.rs:245-257)."""
        return dict(self._parameters)

    def output_channel_count(self, input_counts):
        if self._output_channel_count is not None:
            return list(self._output_channel_count)
        # [spec] defaults: 1 in 1 out -> follow input; else mono outputs
        if self._number_of_inputs == 1 and self._number_of_outputs == 1:
            return [max(1, input_counts[0] if input_counts else 1)]
        return [1] * self._number_of_outputs

    def make_kernel(self, render_ctx):
        if self._processor is None:
            self._processor = self._processor_cls(
                options=self._processor_options, port=self._proc_port)
        return _WorkletKernel(self._processor, render_ctx,
                              self._number_of_outputs,
                              self._output_channel_count)
