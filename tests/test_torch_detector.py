"""The compressor's level detector on the port (webaudio_tpu_torch), on the
CPU: which detector `detector_mode` picks on each device, and the
arithmetic of the CUDA kernel's step.

- `nodes/dynamics_compressor.py::detector_mode`: on a CUDA device `auto`
  runs the sequential kernel at every (N, B) (5a's one 480,000-frame
  block, 5b's 96,000), on the CPU the JAX package's choice (the chunked
  fixed point for constant taus on blocks of >= 128 frames, else the
  generic one); each WEBAUDIO_DETECTOR value forces its detector on both.
- `csrc/detector.cu` computes each step as two candidates from y[i-1],
  a y + (1-a) x and r y + (1-r) x with (1-a) x and (1-r) x taken off the
  chain, and selects one by x > y[i-1].  A numpy emulation of that step is
  bit-equal to `ops/detector.py::detector_reference` (the kernel's
  contract, itself the JAX package's `lax.scan` recurrence) with ties
  x == y[i-1], attack 0, release 0 and per-sample taus, at N and B of 1,
  3, 17 and 4,097.
"""

import numpy as np
import pytest
import torch

from webaudio_tpu_torch.nodes import dynamics_compressor as tdc
from webaudio_tpu_torch.ops import detector as tdet

# 5a's and 5b's compressor (attack 3 ms, release 250 ms at 48 kHz), the
# f32 taus the node computes
TAUS = (float(np.exp(np.float32(-1.0) / (np.float32(0.003) *
                                         np.float32(48000.0)))),
        float(np.exp(np.float32(-1.0) / (np.float32(0.25) *
                                         np.float32(48000.0)))))


@pytest.mark.parametrize("env,device,frames,taus,want", [
    ("auto", "cpu", 480000, TAUS, "chunked"),
    ("auto", "cpu", 96000, TAUS, "chunked"),
    ("auto", "cpu", 96000, None, "fixed_point"),
    ("auto", "cpu", 100, TAUS, "fixed_point"),
    ("auto", "cuda", 480000, TAUS, "seq"),        # 5a
    ("auto", "cuda", 96000, TAUS, "seq"),         # 5b
    ("auto", "cuda:0", 128, None, "seq"),
    ("auto", "cuda", 100, (0.0, 0.99), "seq"),
    ("seq", "cpu", 480000, TAUS, "seq"),
    ("seq", "cuda", 96000, TAUS, "seq"),
    ("chunked", "cpu", 480000, TAUS, "chunked"),
    ("chunked", "cuda", 480000, TAUS, "chunked"),
    ("chunked", "cuda", 96000, (0.0, 0.99), "fixed_point"),
    ("chunked", "cuda", 96000, None, "fixed_point"),
    ("fp64", "cpu", 96000, TAUS, "fp64"),
    ("fp64", "cuda", 96000, TAUS, "fp64"),
    ("fixed_point", "cpu", 480000, TAUS, "fixed_point"),
    ("fixed_point", "cuda", 480000, TAUS, "fixed_point"),
])
def test_detector_mode_by_device(monkeypatch, env, device, frames, taus,
                                 want):
    monkeypatch.setenv("WEBAUDIO_DETECTOR", env)
    assert tdc.detector_mode(taus, frames, device) == want
    assert tdc.detector_mode(taus, frames, torch.device(device)) == want


def test_detector_mode_defaults_to_the_cpu(monkeypatch):
    """Called without a device (as the JAX-parity tests call it), the rule
    is the CPU's."""
    monkeypatch.delenv("WEBAUDIO_DETECTOR", raising=False)
    assert tdc.detector_mode(TAUS, 480000) == "chunked"
    assert tdc.detector_mode((0.0, 0.99), 4096) == "fixed_point"


def two_candidate_step(y0, x, at, rt):
    """numpy emulation of csrc/detector.cu's arithmetic, all in f32 with
    each product and sum rounded apart: per step both candidates from
    y[i-1], then the select."""
    N, B = x.shape
    at = np.broadcast_to(at, (N, B)).astype(np.float32)
    rt = np.broadcast_to(rt, (N, B)).astype(np.float32)
    one = np.float32(1.0)
    ax = (one - at) * x                      # off the chain
    rx = (one - rt) * x
    y = np.empty_like(x)
    prev = y0.astype(np.float32)
    for i in range(B):
        ya = at[:, i] * prev + ax[:, i]
        yr = rt[:, i] * prev + rx[:, i]
        prev = np.where(x[:, i] > prev, ya, yr)
        y[:, i] = prev
    return y


def _inputs(N, B, per_sample, edge, seed):
    rng = np.random.default_rng(seed)
    x = (np.abs(rng.standard_normal((N, B))) * 20).astype(np.float32)
    x[:, B // 3: B // 2] = 25.0              # a held attack, then a release
    y0 = rng.uniform(0, 10, N).astype(np.float32)
    shape = (N, B) if per_sample else (N, 1)
    at = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    rt = rng.uniform(0.9, 0.99999, shape).astype(np.float32)
    if edge == "attack 0":
        at[:] = 0.0
    elif edge == "release 0":
        rt[:] = 0.0
    elif edge == "ties":
        # y stays 0.5 exactly while x is 0.5 (0.5 and 0.75 make every
        # product and sum exact), so x == y[i-1] at each of those steps
        y0[:] = 0.5
        x[:, : max(1, B // 4)] = 0.5
        at[:] = 0.5
        rt[:] = 0.75
    return y0, x, at, rt


@pytest.mark.parametrize("N", [1, 3, 17, 4097])
@pytest.mark.parametrize("B", [1, 3, 17, 4097])
@pytest.mark.parametrize("per_sample", (False, True))
@pytest.mark.parametrize("edge", ("none", "ties", "attack 0", "release 0"))
def test_two_candidate_step_equals_plain_version(N, B, per_sample, edge):
    y0, x, at, rt = _inputs(N, B, per_sample, edge, seed=N * 7 + B)
    if edge == "ties" and B > 2:
        # and one tie mid-row: x[i] set to the y[i-1] these inputs give
        i = B // 2
        x[:, i] = tdet.detector_reference(
            *(torch.from_numpy(a) for a in (y0, x[:, :i].copy(), at[:, :i]
                                            if per_sample else at,
                                            rt[:, :i] if per_sample else rt))
        ).numpy()[:, -1]
    want = tdet.detector_reference(*(torch.from_numpy(a)
                                     for a in (y0, x, at, rt))).numpy()
    got = two_candidate_step(y0, x, at, rt)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if edge == "ties":
        assert (x[:, 0] == y0).all() and (want[:, 0] == 0.5).all()
