"""Media I/O on the port (webaudio_tpu_torch) against the JAX package, on
the CPU: the same streams and elements go through both packages' media
nodes, streams, recorder, element, devices and stream re-chunker, and the
results agree within 1e-5 x peak, or bit for bit where the JAX package's
are exact.

The port's source nodes pull a block from the host and upload it once;
the destination copies a block to the host once (`uploads` /
`host_copies`); in a GraphBatch the lanes pull in turn, as the JAX
package's sequential `pure_callback` does.
"""

import time

import numpy as np
import pytest

import webaudio_tpu as wa
import webaudio_tpu_torch as wt
from webaudio_tpu.media import devices as jdev
from webaudio_tpu.media import element as jel
from webaudio_tpu.media import recorder as jrec
from webaudio_tpu.media import resampler as jres
from webaudio_tpu.media import streams as jstr
from webaudio_tpu.nodes import media_nodes as jnodes
from webaudio_tpu_torch.media import devices as tdev
from webaudio_tpu_torch.media import element as tel
from webaudio_tpu_torch.media import recorder as trec
from webaudio_tpu_torch.media import resampler as tres
from webaudio_tpu_torch.media import streams as tstr
from webaudio_tpu_torch.media.wav import read_wav, write_wav
from webaudio_tpu_torch.nodes import media_nodes as tnodes

FS = 48000.0
# each package's media modules, by the name of its package module
MEDIA = {wa: (jstr, jres, jnodes, jel, jrec, jdev),
         wt: (tstr, tres, tnodes, tel, trec, tdev)}


def _ctx(mod, channels, frames, fs=FS):
    if mod is wt:
        return wt.OfflineAudioContext(channels, frames, fs, device="cpu")
    return wa.OfflineAudioContext(channels, frames, fs)


def _signal(frames, channels=2, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(frames)
    x = np.stack([np.sin(t * (0.01 + 0.013 * c)) for c in range(channels)])
    return (0.5 * x + 0.05 * rng.randn(channels, frames)).astype(np.float32)


def _wait(cond, seconds=30.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def _close(got, want, rel=1e-5):
    peak = float(np.abs(want).max())
    assert got.shape == want.shape and peak > 0
    assert float(np.abs(got - want).max()) <= rel * peak


# --- the stream re-chunker (resampling.rs) ------------------------------------

def _chunks(mod, rows, rate):
    return [mod.AudioBuffer.from_array(np.asarray(r, np.float32)[None], rate)
            for r in rows]


@pytest.mark.parametrize("case", ["concat", "split", "rate", "channels"])
def test_resampler_matches_jax(case):
    """tests/test_reference_vectors_media.py's concat and split semantics
    (fixed quanta, the last zero-padded), plus chunks at another rate and
    with a channel count that grows, through both packages."""
    rows = {"concat": [[1., 2., 3., 4., 5.]] * 3,
            "split": [list(range(1, 11))],
            "rate": [np.sin(np.arange(700) * 0.02)] * 3,
            "channels": [[0.5] * 7]}[case]
    outs = []
    for mod in (wa, wt):
        _, res, *_ = MEDIA[mod]
        chunks = _chunks(mod, rows, 44100.0)
        if case == "channels":
            chunks.append(mod.AudioBuffer.from_array(
                np.ones((2, 9), np.float32), 44100.0))
        target = 48000.0 if case == "rate" else 44100.0
        quantum = {"concat": 10, "split": 5}.get(case, 128)
        outs.append([b.to_array().copy() for b in
                     res.Resampler(iter(chunks), target, quantum=quantum)])
    assert [o.shape for o in outs[1]] == [o.shape for o in outs[0]]
    for got, want in zip(*outs[::-1]):
        np.testing.assert_array_equal(got, want)


def test_stream_tracks_match_jax():
    """MediaStreamTrack's shared cursor (a lagging consumer catches up to
    the newest chunk), PushStreamTrack's queue and the stream helpers."""
    seen = []
    for mod in (wa, wt):
        streams = MEDIA[mod][0]
        track = streams.MediaStreamTrack.from_iterator(
            _chunks(mod, [[1.], [2.], [3.], [4.]], FS))
        a, b = track.iter(), track.iter()
        log = [a.next().to_array()[0, 0], a.next().to_array()[0, 0],
               b.next().to_array()[0, 0], b.next().to_array()[0, 0]]
        push = streams.PushStreamTrack(max_queue=2)
        for v in (5., 6., 7.):
            push.push(_chunks(mod, [[v]], FS)[0])
        log += [push.next_chunk().to_array()[0, 0]]
        push.close()
        log += [push.next_chunk().to_array()[0, 0], push.next_chunk(),
                push.ready_state]
        buf = mod.AudioBuffer.from_array(_signal(300, 1), FS)
        stream = streams.MediaStream.from_buffer(buf)
        log += [len(stream.get_audio_tracks()),
                [c.length for c in stream.get_tracks()[0].iter()]]
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[1][:4] == [1.0, 2.0, 2.0, 3.0]


# --- the source nodes -----------------------------------------------------------

def _stream_graph(mod, frames, data, rate, gain=1.0):
    streams, _, nodes, *_ = MEDIA[mod]
    ctx = _ctx(mod, 2, frames)
    stream = streams.MediaStream.from_buffer(
        mod.AudioBuffer.from_array(data, rate))
    src = nodes.MediaStreamAudioSourceNode(ctx, stream)
    g = ctx.create_gain(gain=gain)
    src.connect(g)
    g.connect(ctx.destination)
    return ctx, src


@pytest.mark.parametrize("rate", [FS, 44100.0])
def test_stream_source_offline_matches_jax(rate):
    frames = 20000
    data = _signal(15000)
    outs = []
    for mod in (wa, wt):
        ctx, src = _stream_graph(mod, frames, data, rate, gain=0.8)
        outs.append(ctx.start_rendering_sync().to_array())
    _close(outs[1], outs[0])
    cg = ctx._cg
    assert src.uploads == -(-cg.total_frames // cg.block_frames)
    if rate == FS:
        np.testing.assert_array_equal(outs[1][:, :15000],
                                      (data * np.float32(0.8)))
        assert not outs[1][:, 15000:].any()


def test_push_track_through_unit_gain_is_exact():
    """A MediaStreamAudioSourceNode fed by a PushStreamTrack gives the
    pushed blocks through a gain of 1 exactly."""
    blocks = [_signal(128, seed=s) for s in range(12)]
    outs = []
    for mod in (wa, wt):
        streams, _, nodes, *_ = MEDIA[mod]
        track = streams.PushStreamTrack()
        for blk in blocks:
            track.push(mod.AudioBuffer.from_array(blk, FS))
        track.close()
        ctx = _ctx(mod, 2, 128 * 16)
        src = nodes.MediaStreamAudioSourceNode(ctx, streams.MediaStream([track]))
        g = ctx.create_gain(gain=1.0)
        src.connect(g)
        g.connect(ctx.destination)
        outs.append(ctx.start_rendering_sync().to_array())
    want = np.concatenate(blocks, axis=1)
    np.testing.assert_array_equal(outs[1][:, :want.shape[1]], want)
    assert not outs[1][:, want.shape[1]:].any()
    np.testing.assert_array_equal(outs[1], outs[0])


def test_stream_source_lanes_pull_in_turn():
    """In a GraphBatch of 3 instances each block pulls once a lane, lane 0
    first: lane i of block b holds the stream's chunk 3b + i."""
    B = 2048
    data = np.arange(12 * B, dtype=np.float32)[None].repeat(2, 0) / (12 * B)
    ctx, src = _stream_graph(wt, 2 * B, data, FS)
    gb = wt.GraphBatch(ctx, batch=3)
    out = gb.render().cpu().numpy()
    blk = gb.cg.block_frames
    nb = out.shape[-1] // blk
    for b in range(nb):
        for lane in range(3):
            k = 3 * b + lane
            np.testing.assert_array_equal(
                out[lane, :, b * blk:(b + 1) * blk],
                data[:, k * blk:(k + 1) * blk])
    assert src.uploads == nb


def _write_clip(tmp_path, seconds=1.0, fs=44100.0):
    data = _signal(int(seconds * fs))
    path = str(tmp_path / "clip.wav")
    write_wav(path, data, fs)
    return path, data, fs


def _element_graph(mod, path, frames, streaming):
    _, _, nodes, element, *_ = MEDIA[mod]
    el = element.MediaElement(path, stream=streaming)
    el.play()
    ctx = _ctx(mod, 2, frames)
    src = nodes.MediaElementAudioSourceNode(ctx, el)
    filt = ctx.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    src.connect(filt)
    filt.connect(ctx.destination)
    try:
        return ctx.start_rendering_sync().to_array(), ctx, src
    finally:
        el.close()


@pytest.mark.parametrize("streaming", [True, False])
def test_element_source_offline_matches_jax(tmp_path, streaming):
    """A MediaElementAudioSourceNode over a WAV file (streamed from disk
    through the codec host where it builds, else decoded whole) into the
    slice graph, in an OfflineAudioContext of one block, against the JAX
    package; over several blocks against the same graph fed by the clip
    as a buffer (the element's lerp at rate fs / FS is the buffer
    source's).  The JAX package is held to one block: its pull is a
    `pure_callback` of loop-invariant operands, which XLA hoists out of
    the block scan, so every later block repeats the first block's pull
    (ROADMAP R8)."""
    path, data, fs = _write_clip(tmp_path)
    one = 16384
    got, ctx, _ = _element_graph(wt, path, one, streaming)
    assert ctx._cg.block_frames == one
    want, _, _ = _element_graph(wa, path, one, streaming)
    _close(got, want)

    frames = int(0.9 * FS)
    got, ctx, src = _element_graph(wt, path, frames, streaming)
    assert src.uploads == -(-frames // ctx._cg.block_frames) == 3
    ref = _ctx(wt, 2, frames)
    bsrc = ref.create_buffer_source()
    bsrc.buffer = wt.AudioBuffer.from_array(data, fs)
    filt = ref.create_biquad_filter(type="lowpass", frequency=2000.0, q=2.0)
    bsrc.connect(filt)
    filt.connect(ref.destination)
    bsrc.start()
    _close(got, ref.start_rendering_sync().to_array())


def test_element_controls_match_jax(tmp_path):
    """Seek, rate, loop and pause pull the same frames in both packages."""
    path, _, fs = _write_clip(tmp_path, seconds=0.5)
    pulls = []
    for mod in (wa, wt):
        el = MEDIA[mod][3].MediaElement(path)
        el.play()
        seq = [el._pull_chunk(300, FS)]
        el.set_current_time(0.2)
        seq.append(el._pull_chunk(300, FS))
        el.playback_rate = 1.7
        seq.append(el._pull_chunk(300, FS))
        el.loop = True
        el.set_current_time(0.49)
        seq.append(el._pull_chunk(1000, FS))
        el.pause()
        seq.append(el._pull_chunk(64, FS))
        pulls.append((seq, el.current_time, el.streaming, el.duration))
        el.close()
    for got, want in zip(pulls[1][0], pulls[0][0]):
        np.testing.assert_array_equal(got, want)
    assert pulls[1][1:] == pulls[0][1:]


# --- the destination and the recorder -------------------------------------------

def _record(mod, frames, data, record=True):
    """source buffer -> gain -> MediaStreamAudioDestinationNode, its stream
    recorded by a MediaRecorder (unless `record` is false); returns
    (render, recorded, node)."""
    _, _, nodes, _, recorder, _ = MEDIA[mod]
    ctx = _ctx(mod, 2, frames)
    src = ctx.create_buffer_source()
    src.buffer = mod.AudioBuffer.from_array(data, FS)
    g = ctx.create_gain(gain=0.5)
    dest = nodes.MediaStreamAudioDestinationNode(ctx)
    src.connect(g)
    g.connect(dest)
    g.connect(ctx.destination)
    src.start()
    if not record:
        return ctx.start_rendering_sync().to_array(), None, dest
    rec = recorder.MediaRecorder(dest.stream)
    blobs = []
    rec.set_ondataavailable(lambda ev: blobs.append(ev.blob))
    rec.start()
    try:
        out = ctx.start_rendering_sync().to_array()
        assert _wait(lambda: not dest._track._queue)
    finally:
        rec.stop()
    assert _wait(lambda: blobs)
    got, rate = read_wav(blobs[0])
    assert rate == FS
    return out, got, dest


def test_recorder_capture_matches_render_and_jax():
    """The recorder finalizes when no chunk comes for 1 s (both
    packages), so each package renders the graph once before recording
    (torch's first render and JAX's compile can take longer)."""
    frames = 40000
    data = _signal(frames)
    for mod in (wt, wa):
        _record(mod, frames, data, record=False)
    out, got, dest = _record(wt, frames, data)
    # the capture holds every rendered block (padded to the block size)
    assert dest.host_copies >= 1
    np.testing.assert_array_equal(got[:, :frames], out)
    jout, jgot, _ = _record(wa, frames, data)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(out, jout)


# --- devices --------------------------------------------------------------------

@pytest.mark.parametrize("mic", [False, True])
def test_devices_and_user_media_match_jax(tmp_path, monkeypatch, mic):
    if mic:
        path, _, _ = _write_clip(tmp_path, seconds=0.05)
        monkeypatch.setenv("WEBAUDIO_VIRTUAL_MIC", path)
    else:
        monkeypatch.delenv("WEBAUDIO_VIRTUAL_MIC", raising=False)
    seen = []
    for mod in (wa, wt):
        dev = MEDIA[mod][5]
        listed = [(d.device_id, d.group_id, d.kind.value, d.label)
                  for d in dev.enumerate_devices_sync()]
        stream = dev.get_user_media_sync(dev.MediaTrackConstraints(
            sample_rate=FS, channel_count=2))
        it = stream.get_audio_tracks()[0].iter()
        pulled = np.concatenate([it.next().to_array() for _ in range(40)],
                                axis=1)
        seen.append((listed, pulled))
    assert seen[1][0] == seen[0][0]
    np.testing.assert_array_equal(seen[1][1], seen[0][1])
    assert bool(seen[1][1].any()) == mic


def test_online_stream_nodes_match_jax():
    """In an AudioContext: a MediaStreamAudioSourceNode -> gain ->
    destination and a MediaStreamAudioDestinationNode, against JAX's."""
    from test_torch_online import drive

    data = _signal(30000)
    frames = 24 * 1024
    runs = []
    for mod in (wa, wt):
        streams, _, nodes, *_ = MEDIA[mod]
        captured = {}

        def build(ctx):
            stream = streams.MediaStream.from_buffer(
                mod.AudioBuffer.from_array(data, FS))
            src = ctx.create_media_stream_source(stream)
            g = ctx.create_gain(gain=0.25)
            dest = ctx.create_media_stream_destination()
            src.connect(g)
            g.connect(ctx.destination)
            g.connect(dest)
            captured["dest"] = dest
            captured["src"] = src
            return {}

        chunks, ctx, _ = drive(mod, frames, build=build)
        out = np.concatenate(chunks, axis=1)[:, :frames]
        track = captured["dest"].stream.get_audio_tracks()[0]
        pushed = []
        while track._queue:
            pushed.append(track.next_chunk().to_array())
        runs.append((out, np.concatenate(pushed, axis=1), captured))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    np.testing.assert_array_equal(runs[1][0][:, :30000 if frames > 30000
                                  else frames],
                                  (data * np.float32(0.25))[:, :frames])
    cap = runs[1][2]
    assert cap["src"].uploads == cap["dest"].host_copies >= 24
