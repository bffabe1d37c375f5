"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a small size, with one fault planted where the port
produces it.  Each cell gets the faults it can have: half of a batch left
out, an answer altered where it is produced, and a step that returns its
state unchanged (the feedback delay's ring)."""

import numpy as np
import pytest
import torch

from wabench.tests import tiny


def _half_left_out(monkeypatch):
    from webaudio_tpu_torch.parallel import batch

    walk = batch.GraphBatch._walk

    def broken(self):
        outs = walk(self)
        for out in outs:
            out[out.shape[0] // 2:] = 0.0
        return outs
    monkeypatch.setattr(batch.GraphBatch, "_walk", broken)


def _code_altered(monkeypatch):
    from webaudio_tpu_torch.parallel import batch

    dither = batch.dither_i16

    def broken(x, seed=0, out=None, offset=0):
        codes = dither(x, seed, out, offset)
        codes[..., 0, 1000] ^= 0x4000      # a wrong sample in every instance
        return codes
    monkeypatch.setattr(batch, "dither_i16", broken)


def _sample_altered(monkeypatch):
    from webaudio_tpu_torch.context import offline

    render = offline.OfflineAudioContext.start_rendering_sync

    def broken(self, *a, **kw):
        buf = render(self, *a, **kw)
        buf.to_array()[0, 1000] += 0.5
        return buf
    monkeypatch.setattr(offline.OfflineAudioContext, "start_rendering_sync",
                        broken)


def _state_unchanged(monkeypatch):
    from webaudio_tpu_torch.nodes import delay

    monkeypatch.setattr(delay._DelayKernel, "process_writer",
                        lambda self, scope, state, inputs, params: state)


FAULTS = [("mastering.augment", _half_left_out),
          ("mastering.augment", _code_altered),
          ("reverb.bounce", _sample_altered),
          ("reverb.bounce", _state_unchanged)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    correct, _, _ = tiny.run(name, seconds=0.3)
    assert correct
    fault(monkeypatch)
    correct, checks, run = tiny.run(name, seconds=0.3)
    assert not correct, checks


@pytest.mark.cuda
def test_card_run_of_a_small_cell(card):
    """On a card: a small bounce through the same drivers is correct."""
    from wabench import run as runner

    c = tiny.cell("reverb.bounce")
    r, drv, dev, forbidden = runner.execute(c, 7, 0.5, 0, device="cuda")
    correct, checks = runner.judge(c, r, drv)
    assert correct and not forbidden and dev["platform"] == "gpu", checks
    assert np.isfinite(float(torch.cuda.max_memory_allocated()))
