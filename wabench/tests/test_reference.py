"""The plain reference agrees with a small render of the port on the CPU,
through the benchmark's own drivers: each cell, and each pairing of a
configuration with a driver that a later cell could make by data alone.
Also the reference's own pieces against independent forms."""

import numpy as np
import pytest
import torch

from wabench.reference import philox, resample
from wabench.tests import tiny



@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_correct_on_cpu(name):
    correct, checks, run = tiny.run(name, seconds=0.5)
    assert correct, checks
    assert run.requests and all(r.ok for r in run.requests)


# (configuration, traffic, vary, the check's number, its bound): every
# driver on every configuration, the pairings that no cell holds yet
PAIRINGS = [("mastering", "bounce", {"drive": [1.0, 5.0]}, "max_rel_err",
             1e-4),
            ("reverb", "augment", {}, "max_code_diff", 4)]


@pytest.mark.parametrize("config,mix,vary,key,bound", PAIRINGS,
                         ids=[f"{c}.{m}" for c, m, *_ in PAIRINGS])
def test_any_driver_runs_any_configuration(config, mix, vary, key, bound):
    r, drv = tiny.execute(tiny.pairing(config, mix, vary), seconds=0.3)
    assert r.requests and all(q.ok for q in r.requests)
    assert drv.check()[key] <= bound


def test_a_batch_of_the_reverb_keeps_its_impulse_response():
    with pytest.raises(ValueError, match="impulse response"):
        tiny.execute(tiny.pairing("reverb", "augment", {"ir": "pool"}),
                     seconds=0.2, seed=3)


def test_dither_matches_the_port_bounce_definition():
    """The same random stream as the port's bounce; the codes of float32
    samples then differ by at most one, where the port's float32 product
    and sum round across a code boundary that exact arithmetic does not."""
    from webaudio_tpu_torch.ops.dither import (dither_i16_reference,
                                               uniforms)

    assert np.array_equal(philox.uniforms(8, 4003, 2**32 + 99),
                          uniforms(4003, 2**32 + 99, "cpu", 8).numpy())
    x = torch.linspace(-1.2, 1.2, 4 * 1001, dtype=torch.float32)
    want = dither_i16_reference(x, 12345, offset=8).numpy().astype(int)
    got = philox.dither_i16(x.numpy(), 12345, 8).astype(int)
    assert np.abs(got - want).max() <= 1 and (got != want).mean() < 0.01
    assert np.array_equal(philox.dither_i16(x.numpy()[3:], 12345, 11),
                          got[3:])


def test_resample_keeps_the_ends_and_the_length():
    x = np.random.default_rng(0).standard_normal((2, 1000))
    y = resample.resample(x, 44100.0, 48000.0)
    assert y.shape == (2, 1089)
    assert np.allclose(y[:, [0, -1]], x[:, [0, -1]])
    assert resample.resample(x, 48000.0, 48000.05) is not None
