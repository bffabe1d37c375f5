"""A GraphBatch's change-tracked staging (webaudio_tpu_torch/parallel/batch.py)
where a copy to the card can be in flight: a caller that reuses its row
array at once, and overrides between replays of a captured walk.  The CPU
cases run here; the card cases skip without CUDA.

The file imports no JAX, so on a GPU machine without it:

    python -m pytest tests/test_torch_staging.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import webaudio_tpu_torch as wt

FS = 48000.0


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device(request.param)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _clips(n, frames, seed):
    rng = np.random.default_rng(seed)
    return (0.4 * rng.standard_normal((n, 2, frames))).astype(np.float32)


def _shaped_sweep(device, n, frames):
    """A looping clip -> lowpass whose frequency sweeps (a dense row) ->
    WaveShaper: -> (GraphBatch of n, source, filter, shaper)."""
    ctx = wt.OfflineAudioContext(2, frames, FS, device=device)
    src = ctx.create_buffer_source(loop=True)
    src.buffer = wt.AudioBuffer.from_array(_clips(1, 3000, 0)[0], FS)
    src.start()
    filt = ctx.create_biquad_filter(type="lowpass", q=3.0)
    filt.frequency.set_value_at_time(200.0, 0.0)
    filt.frequency.exponential_ramp_to_value_at_time(8000.0, frames / FS)
    shaper = ctx.create_wave_shaper(
        curve=np.tanh(np.linspace(-2, 2, 512)).astype(np.float32))
    src.connect(filt)
    filt.connect(shaper)
    shaper.connect(ctx.destination)
    return wt.GraphBatch(ctx, batch=n), src, filt, shaper


def _rows(n, frames, k):
    return (np.geomspace(200.0, 8000.0, frames, dtype=np.float32)[None]
            * np.linspace(0.5 + 0.1 * k, 2.0, n, dtype=np.float32)[:, None])


def _curves(n, k):
    drive = np.linspace(1.0, 4.0, n)[:, None] + k
    return np.tanh(drive * np.linspace(-1, 1, 512)[None]).astype(np.float32)


def test_render_stream_snapshots_a_reused_row_array(device):
    """`updates` rewrites one caller-owned array in place each call, while
    the batch before it is still in flight on a card: the stream's bounces
    equal three direct ones."""
    n, frames = 16, 40000
    gb, _, filt, _ = _shaped_sweep(device, n, frames)
    scratch = np.empty((n, frames), np.float32)

    def updates(gb_, k):
        scratch[:] = _rows(n, frames, k)
        gb_.override_param(filt, "frequency", scratch)
        scratch[:] = -1.0          # the caller's next use, at once

    got = list(gb.render_stream(3, updates, fetch="i16"))
    ref = _shaped_sweep(device, n, frames)[0]
    for k, out in enumerate(got):
        updates(ref, k)
        np.testing.assert_array_equal(out, ref.render_i16(0).cpu().numpy())
    assert not np.array_equal(got[0], got[1])


def _given(n, frames, k):
    """A request's row, curves and clips."""
    return _rows(n, frames, k), _curves(n, k), _clips(n, 3000, k + 1)


def _apply(gb, src, filt, shaper, given):
    gb.override_param(filt, "frequency", given[0])
    gb.override_buffer(shaper, given[1], key="curve")
    gb.override_buffer(src, given[2])


def test_overrides_between_replays_keep_the_captured_graphs(cuda,
                                                            monkeypatch):
    """A captured batch takes a new row, new curves and new clips between
    replays: the plan keeps its graphs (the buffers keep their addresses),
    and each render equals the eager walk of a batch given the same."""
    n, frames = 8, 9600
    gb, *nodes = _shaped_sweep(cuda, n, frames)
    # per-instance curves and clips from the start, as a deployment stages
    # them before it serves
    _apply(gb, *nodes, _given(n, frames, 9))
    for _ in range(3):             # the third walk captures
        gb.render()
    graphs = dict(gb.cg.graphs)
    assert graphs
    replays = sum(g.replays for g in graphs.values())
    src, filt, shaper = nodes
    for k in range(3):
        _apply(gb, *nodes, _given(n, frames, k))
        got = gb.render()
        assert {f"n{filt.node_id}.frequency", f"n{shaper.node_id}.curve",
                f"n{src.node_id}.data_rows"} <= set(gb.stage_stats["uploaded"])
        assert gb.cg.graphs == graphs, k
        monkeypatch.setenv("WEBAUDIO_CUDA_GRAPHS", "0")
        eager, *eager_nodes = _shaped_sweep(cuda, n, frames)
        _apply(eager, *eager_nodes, _given(n, frames, k))
        want = eager.render()
        monkeypatch.delenv("WEBAUDIO_CUDA_GRAPHS")
        assert not eager.cg.graphs
        torch.cuda.synchronize()
        assert torch.equal(got, want), k
    assert sum(g.replays for g in graphs.values()) >= replays + 3
