"""Entry points for an outside caller: the flagship graph's forward step
with its example arguments, and a dry run of every sharded path on n
devices.

The port's counterpart of the repository's `__graft_entry__.py`.  The
flagship graph is a copy of that file's, built on the port.  There is no
subprocess: the JAX file re-executes itself to give XLA n virtual host
devices, while here a mesh names its devices directly, repeats allowed
(`parallel/mesh.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import automation, convert
from .context.offline import OfflineAudioContext
from .graph import compiler
from .parallel.batch import GraphBatch, MixedGraphBatch
from .parallel.mesh import Mesh, on_device
from .parallel.segments import render_time_sharded


def flagship_context(fs=48000.0, seconds=0.25, device="cuda"):
    """Flagship offline graph: sampled source -> resonant biquad sweep ->
    gain envelope -> delay echo -> destination (BASELINE.json config 1+)."""
    n = int(fs * seconds)
    ctx = OfflineAudioContext(2, n, fs, device=device)

    buf = ctx.create_buffer(2, 2048, fs)
    t = np.arange(2048)
    for c in range(2):
        buf.copy_to_channel(
            (np.sin(2 * np.pi * (220 + 110 * c) * t / fs)
             * np.exp(-t / 800)).astype(np.float32), c)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = buf
    src.start()

    filt = ctx.create_biquad_filter(type="lowpass", q=4.0)
    filt.frequency.set_value_at_time(300.0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(8000.0, seconds)

    env = ctx.create_gain(gain=0.0)
    env.gain.linear_ramp_to_value_at_time(1.0, seconds * 0.5)

    echo = ctx.create_delay(max_delay_time=0.5)
    echo.delay_time.value = 0.05

    src.connect(filt)
    filt.connect(env)
    env.connect(ctx.destination)
    env.connect(echo)
    echo.connect(ctx.destination)
    return ctx


def entry(device="cuda"):
    """(forward step on the flagship graph, example args).

    forward(states, frame0s, xs, resources) walks the plan's blocks
    (`compiler.scan_render`) over one instance and returns (C, padded)
    f32; its arguments have the JAX entry's layout: states and resources
    without an instance axis (as `zero_states` and `collect_resources`
    give them, here as tensors on the device), frame0s the blocks' first
    frames, xs the packed rows (nb, P, B)."""
    ctx = flagship_context(device=device)
    cg = compiler.compile_graph(dict(ctx._nodes), list(ctx._edges),
                                ctx.sample_rate, ctx.length,
                                ctx._destination.node_id, ctx.device)
    B = cg.block_frames
    nb = -(-ctx.length // B)
    xs = convert.upload(compiler.block_rows(
        compiler.pack_dense_params(cg, nb * B), B), ctx.device)
    frame0s = np.arange(nb, dtype=np.int32) * B
    states = compiler.zero_states(cg)
    resources = convert.to_torch_tree(compiler.collect_resources(cg),
                                      ctx.device)

    def forward(states, frame0s, xs, resources):
        with on_device(cg.device):
            _, out = compiler.scan_render(
                cg, convert.batch_states(states, 1),
                [int(f) for f in frame0s], xs[None],
                convert.tree_map(lambda r: r[None], resources))
        return out[0]

    return forward, (states, frame0s, xs, resources)


def _mesh_devices(n_devices, device):
    if torch.device(device).type == "cpu":
        return ["cpu"] * n_devices
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device is visible; "
                           "pass device='cpu' for a CPU mesh")
    return [f"cuda:{i % count}" for i in range(n_devices)]


def _close(name, got, want, atol):
    err = float(np.abs(np.asarray(got) - np.asarray(want, np.float32)).max())
    if not err <= atol:
        raise AssertionError(f"{name}: max |err| {err} > {atol}")
    return err


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the four sharded paths on a mesh of n_devices entries (the
    visible cards in turn, or n CPU entries with device="cpu") and check
    each against unsharded renders; returns each leg's max |err|.

    1. a GraphBatch of 2n flagship graphs sharded over "graphs", a sweep
       a lane, lane 0 the context's own automation, against the
       context's start_rendering_sync (atol 2e-5);
    2. render_time_sharded over a "time" mesh against the sequential
       render (2e-5);
    3. a MixedGraphBatch of n synths (one bucket, sharded) and one other
       topology (a bucket of one, unsharded), each lane against its own
       render (2e-5);
    4. a MixedGraphBatch of n feedback-delay cycles (the two-rate plan)
       over the mesh, each lane against its own render (2e-6); their
       constant feedback gains bucket them apart, so with n > 1 each
       bucket of one renders unsharded, as in the JAX file."""
    device = device or "cuda"
    devs = _mesh_devices(n_devices, device)
    errs = {}

    ctx = flagship_context(seconds=0.05, device=device)
    batch = GraphBatch(ctx, batch=2 * n_devices,
                       mesh=Mesh(devs, ("graphs",)))
    filt = next(nd for nd in ctx._nodes.values()
                if type(nd).__name__ == "BiquadFilterNode")
    own = automation.compile_timeline(
        filt.frequency._timeline.snapshot(), ctx.sample_rate, ctx.length,
        is_a_rate=True, force_dense=True).dense
    base = np.linspace(400.0, 4000.0, ctx.length, dtype=np.float32)
    depths = np.linspace(0.5, 2.0, 2 * n_devices, dtype=np.float32)
    overrides = depths[:, None] * base[None, :]
    overrides[0] = np.asarray(own, np.float32)[: ctx.length]
    batch.override_param(filt, "frequency", overrides)
    arr = batch.render().cpu().numpy()[:, :, : ctx.length]
    if arr.shape != (2 * n_devices, 2, ctx.length):
        raise AssertionError(f"sharded batch shape {arr.shape}")
    if not np.isfinite(arr).all() or not np.abs(arr).max() > 0.0:
        raise AssertionError("sharded batch is silent or not finite")
    if not np.abs(arr[1] - arr[-1]).max() > 1e-6:
        raise AssertionError("sharded batch lanes are identical")
    errs["batch"] = _close("sharded batch lane 0 vs the unsharded render",
                           arr[0], ctx.start_rendering_sync().to_array(),
                           2e-5)

    def saw_lowpass():
        c = OfflineAudioContext(2, int(48000 * 0.5), 48000.0, device=device)
        osc = c.create_oscillator(type="sawtooth", frequency=220.0)
        f2 = c.create_biquad_filter(type="lowpass", frequency=2500.0, q=3.0)
        osc.connect(f2)
        f2.connect(c.destination)
        osc.start()
        return c

    sharded = render_time_sharded(saw_lowpass(), mesh=Mesh(devs, ("time",)))
    if not np.isfinite(sharded).all() or not np.abs(sharded).max() > 0.0:
        raise AssertionError("time-sharded render is silent or not finite")
    errs["time"] = _close("time-sharded vs the sequential render", sharded,
                          saw_lowpass().start_rendering_sync().to_array(),
                          2e-5)

    def synth(ramp):
        c = OfflineAudioContext(1, int(48000 * 0.05), 48000.0, device=device)
        o = c.create_oscillator(frequency=330.0)
        g = c.create_gain(gain=0.0)
        g.gain.linear_ramp_to_value_at_time(ramp, c.length / 48000.0)
        o.connect(g)
        g.connect(c.destination)
        o.start()
        return c

    ramps = [0.2 + 0.1 * i for i in range(n_devices)]
    mb = MixedGraphBatch([synth(r) for r in ramps] + [saw_lowpass()],
                         mesh=Mesh(devs, ("graphs",)))
    meshes = sorted((len(idxs), gb.mesh is not None)
                    for idxs, gb in mb._buckets)
    if meshes != sorted([(n_devices, True), (1, n_devices == 1)]):
        raise AssertionError(f"mixed buckets (size, sharded): {meshes}")
    outs = mb.render()
    errs["mixed"] = max(
        _close(f"mixed-corpus lane {i} vs its own render", outs[i],
               synth(r).start_rendering_sync().to_array(), 2e-5)
        for i, r in enumerate(ramps))

    def cycle(fbgain):
        c = OfflineAudioContext(1, int(48000 * 0.2), 48000.0, device=device)
        o = c.create_oscillator(frequency=330.0)
        o.start()
        o.stop(0.05)
        d = c.create_delay(max_delay_time=0.1)
        d.delay_time.value = 0.02
        fb = c.create_gain(gain=fbgain)
        o.connect(d)
        d.connect(fb)
        fb.connect(d)
        fb.connect(c.destination)
        return c

    probe = cycle(0.5)
    cg = compiler.compile_graph(dict(probe._nodes), list(probe._edges),
                                probe.sample_rate, probe.length,
                                probe._destination.node_id, probe.device)
    if not cg.block_frames > int(0.02 * 48000):
        raise AssertionError("the two-rate compiler did not engage")
    gains = [0.3 + 0.05 * i for i in range(n_devices)]
    mb2 = MixedGraphBatch([cycle(g) for g in gains],
                          mesh=Mesh(devs, ("graphs",)))
    outs2 = mb2.render()
    errs["cycles"] = max(
        _close(f"two-rate lane {i} vs its own render", outs2[i],
               cycle(g).start_rendering_sync().to_array(), 2e-6)
        for i, g in enumerate(gains))
    return errs
