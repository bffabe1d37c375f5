"""DynamicsCompressorNode: spec compression curve with lookahead.

reference: src/node/dynamics_compressor.rs (Giannoulis et al. design:
gain computer in dB with soft knee, branching attack/release peak detector,
makeup gain = (1/curve(1))^0.6, max-across-channels sidechain, fixed
one-quantum lookahead delay).  Ported from
`webaudio_tpu/nodes/dynamics_compressor.py`.

Everything but the level detector is elementwise tensor math over (N, B).
The detector `y[n] = a y[n-1] + (1-a) x[n]`, with `a` chosen by
`x[n] > y[n-1]`, is sequential.  `detector_mode` picks how it runs:

- on the card, by default (`auto`): the sequential recurrence, one launch
  of the hand-written CUDA kernel (`ops/detector.py`, `csrc/detector.cu`)
  a block, with no host sync;
- on the CPU, by default, as the JAX package runs it: with constant
  attack/release taus (k-rate, no automation) that pass `chunked_taus_ok`,
  on blocks of >= 128 frames, the branch-pattern fixed point with a
  closed-form solve per 128-sample chunk (`_detector_fixed_point_chunked`);
  otherwise the fixed point with a first-order recursive-doubling scan
  (`_detector_fixed_point`);
- WEBAUDIO_DETECTOR=seq: the sequential recurrence on any device (the
  plain version on the CPU); =chunked: the CPU's default on any device;
  =fp64: the fixed point in f64; =fixed_point: the generic fixed point.

In the fixed points convergence is judged per instance; the instances whose
branch pattern has not settled after `max_iters` take the sequential
kernel, the rest keep their fixed point.  Each fixed-point iteration asks
the host whether any instance's pattern changed: one device sync per
iteration.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import RENDER_QUANTUM_SIZE, NotSupportedError
from ..graph.compiler import Kernel
from ..ops.detector import detector_scan
from ..ops.mixing import ChannelCountMode
from ..param import AudioParamDescriptor, AutomationRate
from .audio_node import AudioNode, ChannelConfig

_CH = 128  # chunk width of the chunked detector


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps y -> a[k] y + b[k] along the last
    axis: (A[k], B[k]) composes maps 0..k.  Recursive doubling (Hillis-
    Steele): at distance d, element k becomes el[k] o el[k-d], the
    composition `jax.lax.associative_scan` computes in another
    association order (ops/recurrence.py does the same for second order)."""
    n = a.shape[-1]
    d = 1
    while d < n:
        a, b = (torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], -1),
                torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]],
                          -1))
        d *= 2
    return a, b


def _sequential_rows(y, rows, y0, x, at, rt):
    """y with the instances `rows` (a bool (N,) mask) replaced by the exact
    sequential recurrence."""
    idx = torch.nonzero(rows).reshape(-1)
    sel = [t.index_select(0, idx) if isinstance(t, torch.Tensor) and t.dim()
           else t for t in (at, rt)]
    seq = detector_scan(y0.index_select(0, idx).contiguous(),
                        x.index_select(0, idx).contiguous(), *sel)
    y = y.clone()
    y[idx] = seq.to(y.dtype)
    return y


def _fixed_point(solve, pattern_of, pat0, max_iters):
    """The branch-pattern iteration shared by both fixed-point detectors:
    solve, recompute each instance's pattern, repeat while any instance's
    pattern changed (one host sync an iteration).  Returns (y, the bool (N,)
    mask of instances whose pattern had not settled)."""
    y = solve(pat0)
    pat = pat0
    changed = torch.ones(pat0.shape[0], dtype=torch.bool, device=pat0.device)
    for _ in range(max_iters):
        newpat = pattern_of(y)
        changed = (newpat != pat).any(dim=-1)
        if not bool(changed.any()):
            break
        y = solve(newpat)
        pat = newpat
    return y, changed


def _detector_fixed_point(y0, x, at, rt, max_iters=24, dtype=torch.float32):
    """Branch-pattern fixed-point detector over (N, B).

    y[n] = tau_n * y[n-1] + (1 - tau_n) * x[n], with tau_n chosen by
    x[n] > y[n-1], is a composition of piecewise-linear maps that are
    continuous at their breakpoints (both branches agree at y == x), so
    iterating [guess the branch pattern -> solve the linear time-varying
    recurrence with one scan -> recompute the pattern] converges to the
    exact forward solution; near-breakpoint mispredictions perturb the
    result by O(eps) only.  The scan runs in f32 by default
    (WEBAUDIO_DETECTOR=fp64: f64).  Instances still changing after
    `max_iters` (possible with attack_tau == 0, where one mispredicted
    attack re-seeds everything after it) take the exact sequential
    recurrence."""
    N, B = x.shape
    xd = x.to(dtype)
    at = torch.broadcast_to(at, x.shape)
    rt = torch.broadcast_to(rt, x.shape)
    atd, rtd = at.to(dtype), rt.to(dtype)
    y0d = y0.to(dtype)[:, None]

    def solve(pat):
        tau = torch.where(pat, atd, rtd)
        As, Bs = _affine_scan(tau, (1.0 - tau) * xd)
        return As * y0d + Bs

    def pattern_of(y):
        return xd > torch.cat([y0d, y[:, :-1]], -1)

    y, changed = _fixed_point(solve, pattern_of, xd > y0d, max_iters)
    if bool(changed.any()):
        y = _sequential_rows(y, changed, y0.to(torch.float32),
                             x.to(torch.float32), at.to(torch.float32),
                             rt.to(torch.float32))
    return y.to(torch.float32)


def _detector_fixed_point_chunked(y0, x, a: float, r: float, max_iters=24):
    """Constant-tau fixed-point detector with a closed-form solve per
    128-sample chunk, over (N, B).

    With constant attack/release taus the linear-recurrence solve given a
    branch pattern is, per chunk,

        A[j]  = a^S[j] * r^(j+1-S[j])      S = # attack steps (prefix)
        y[j]  = A[j] * (y_chunk0 + sum_{k<=j} (1-tau_k) x_k / A[k])

    Both prefix sums are inclusive cumulative sums along the chunk (the
    JAX package's triangular matmuls at Precision.HIGHEST; a cumsum is
    full f32 on any device, with no TF32 path), and the 1/A[k] terms stay
    in range because `chunked_taus_ok` guarantees a^128, r^128 >= 1e-20.
    Chunk boundaries compose through a small (N, nc) affine scan.  Same
    fixed-point iteration and per-instance fallback as
    `_detector_fixed_point`."""
    N, B = x.shape
    nc = -(-B // _CH)
    pad = nc * _CH - B
    dev = x.device
    xc = torch.nn.functional.pad(x, (0, pad)).reshape(N, nc, _CH)
    la = float(np.float32(np.log(np.float64(a))))
    lr = float(np.float32(np.log(np.float64(r))))
    af = float(np.float32(a))
    rf = float(np.float32(r))
    jrow = torch.arange(1, _CH + 1, dtype=torch.float32, device=dev)
    y0f = y0.to(torch.float32)

    def solve(pat):
        patc = torch.nn.functional.pad(pat, (0, pad)).reshape(N, nc, _CH)
        S = torch.cumsum(patc.to(torch.float32), -1)
        logA = S * la + (jrow - S) * lr
        A = torch.exp(logA)
        tau = torch.where(patc, af, rf)
        V = torch.cumsum((1.0 - tau) * xc * torch.exp(-logA), -1)
        # each chunk's end map (y_chunk0 -> y_end), composed across chunks
        Ae = A[..., -1]
        Acum, Bcum = _affine_scan(Ae, Ae * V[..., -1])
        ystart = torch.cat([y0f[:, None],
                            Acum[:, :-1] * y0f[:, None] + Bcum[:, :-1]], -1)
        y = A * (ystart[..., None] + V)
        return y.reshape(N, -1)[:, :B]

    def pattern_of(y):
        return x > torch.cat([y0f[:, None], y[:, :-1]], -1)

    y, changed = _fixed_point(solve, pattern_of, x > y0f[:, None], max_iters)
    if bool(changed.any()):
        # the chunked guard excludes a == 0, but r == 0 or adversarial
        # inputs can still cascade the pattern front past max_iters
        y = _sequential_rows(y, changed, y0f, x, af, rf)
    return y


def chunked_taus_ok(a: float, r: float) -> bool:
    """Static range guard for the chunked detector: per-chunk products
    a^128, r^128 must stay >= ~1e-20 so the 1/A terms cannot overflow."""
    a = float(a)
    r = float(r)
    return (a > 0.0 and r > 0.0
            and a ** _CH >= 1e-20 and r ** _CH >= 1e-20)


def detector_mode(const_taus, frames: int, device="cpu") -> str:
    """Which detector `_detector` runs on a block of `frames` samples on
    `device`: "seq", "fp64", "chunked" or "fixed_point" (WEBAUDIO_DETECTOR,
    then the device, then the chunked guard).

    On a CUDA device `auto` is "seq" at every (N, B): the kernel walks each
    instance's B samples once, in one launch, and the chunked fixed point
    sweeps the block several times an iteration with a host sync after
    each.  On an H100 (`chip_smoke.py` phase v) the kernel took ~4.8 ms at
    5a's (1, 480,000) and ~1.1 ms at 5b's (1,024, 96,000) against the
    chunked path's 11.5-15.3 and 143-147 ms, and led at every shape of
    the phase's sweep (B from 128 to 480,000, N from 1 to 8,192): by
    2.3-3.2x at 5a's shape, 7x or more at the others.  No crossover, so N
    and B do not enter the rule.  The CPU keeps the JAX package's
    choice."""
    mode = os.environ.get("WEBAUDIO_DETECTOR", "auto")
    if mode in ("seq", "fp64"):
        return mode
    if mode == "auto" and torch.device(device).type == "cuda":
        return "seq"
    if const_taus is not None and mode in ("auto", "chunked") and \
            chunked_taus_ok(*const_taus) and frames >= _CH:
        return "chunked"
    return "fixed_point"


def _detector(y0, x, at, rt, const_taus=None):
    """y0 (N,), x (N, B); at, rt () or (N, B).  const_taus: (a, r) floats
    when the kernel knows the taus are constants (k-rate, no automation),
    which enables the chunked solve; None keeps the generic paths."""
    mode = detector_mode(const_taus, x.shape[-1], x.device)
    if mode == "seq":
        return detector_scan(y0.contiguous(), x.contiguous(), at, rt)
    if mode == "fp64":
        return _detector_fixed_point(y0, x, at, rt, dtype=torch.float64)
    if mode == "chunked":
        return _detector_fixed_point_chunked(y0, x, *const_taus)
    return _detector_fixed_point(y0, x, at, rt)


def _db_to_lin(v):
    return torch.pow(10.0, v / 20.0)


def _lin_to_db(v):
    return torch.where(v == 0.0, -1000.0,
                       20.0 * torch.log10(torch.clamp(v, min=1e-45)))


def _rows(p):
    """A param as the detector's layout: () stays, (N, 1, B) -> (N, B)."""
    return p if p.dim() == 0 else p[:, 0, :]


class _CompressorKernel(Kernel):
    def __init__(self, channels: int, sample_rate: float, device,
                 param_plans=None):
        self.channels = channels
        self.sample_rate = sample_rate
        self.device = device
        # constant attack/release taus unlock the chunked detector; the
        # f32 tau math mirrors the computation in process() exactly
        self.const_taus = None
        plans = param_plans or {}
        ap = plans.get("attack")
        rp = plans.get("release")
        if ap is not None and rp is not None and \
                ap.is_constant and rp.is_constant:
            fs = np.float32(sample_rate)

            def tau(v):
                v = np.float32(np.clip(v, 0.0, 1.0))
                if v == 0.0:
                    return 0.0
                return float(np.exp(np.float32(-1.0)
                                    / (np.maximum(v, np.float32(1e-30))
                                       * fs)))

            self.const_taus = (tau(ap.scalar), tau(rp.scalar))
        # ~6 ms lookahead realised as whole render quanta, like the
        # reference's ring of ceil(fs*0.006/128)+1 quanta read one slot
        # behind the write head (dynamics_compressor.rs:251-254, 452-459):
        # the effective delay is ceil(fs*0.006/128) quanta
        q = RENDER_QUANTUM_SIZE
        self.delay_frames = int(np.ceil(sample_rate * 0.006 / q)) * q

    def init_state(self):
        return {
            "detector": torch.zeros((), dtype=torch.float32,
                                    device=self.device),
            "delay": torch.zeros((self.channels, self.delay_frames),
                                 dtype=torch.float32, device=self.device),
            "reduction": torch.zeros((), dtype=torch.float32,
                                     device=self.device),
        }

    def process(self, scope, state, inputs, params):
        x = inputs[0]                        # (N, C, B)
        N, _, B = x.shape
        fs = self.sample_rate

        # k-rate params, () or (N, B); formulas reference: :364-390
        threshold, knee, ratio, attack, release = (
            _rows(params[k]) for k in ("threshold", "knee", "ratio",
                                       "attack", "release"))
        half_knee = knee / 2.0
        knee_partial = (1.0 / ratio - 1.0) / (2.0 * torch.clamp(knee, min=1e-30))
        attack_tau = torch.exp(-1.0 / (torch.clamp(attack, min=1e-30) * fs))
        attack_tau = torch.where(attack == 0.0, 0.0, attack_tau)
        release_tau = torch.exp(-1.0 / (torch.clamp(release, min=1e-30) * fs))
        release_tau = torch.where(release == 0.0, 0.0, release_tau)
        full_range_gain = threshold + (-threshold / ratio)
        full_range_makeup = 1.0 / _db_to_lin(full_range_gain)
        makeup_gain = 20.0 * torch.log10(full_range_makeup ** 0.6)

        # sidechain: max |x| across channels (reference: :397-407)
        sample_db = _lin_to_db(torch.amax(torch.abs(x), dim=1))    # (N, B)

        # gain computer with soft knee (reference: :413-425)
        over = sample_db - threshold
        knee_branch = sample_db + (over + half_knee) ** 2 * knee_partial
        attenuated = torch.where(
            sample_db <= threshold - half_knee, sample_db,
            torch.where(sample_db <= threshold + half_knee,
                        knee_branch, threshold + over / ratio))
        attenuation = sample_db - attenuated                       # xL

        # branching level detector (reference: :427-445)
        detector = _detector(state["detector"], attenuation, attack_tau,
                             release_tau, const_taus=self.const_taus)

        reduction_db = -detector + makeup_gain
        reduction_lin = _db_to_lin(reduction_db)

        # apply to the signal delayed by the lookahead (reference: :452-470)
        ext = torch.cat([state["delay"], x], dim=-1)
        out = ext[..., :B] * reduction_lin[:, None, :]
        new_state = {
            "detector": detector[:, -1],
            "delay": ext[..., B:],
            "reduction": reduction_db[:, -1],
        }
        return new_state, [out]


class DynamicsCompressorNode(AudioNode):
    _number_of_inputs = 1
    _number_of_outputs = 1

    def __init__(self, context, attack: float = 0.003, knee: float = 30.0,
                 ratio: float = 12.0, release: float = 0.25,
                 threshold: float = -24.0, **options):
        cfg = ChannelConfig(count=2, mode=ChannelCountMode.CLAMPED_MAX)
        super().__init__(context, channel_config=cfg)
        mk = lambda name, dv, lo, hi: self._register_param(
            name, AudioParamDescriptor(
                name=name, automation_rate=AutomationRate.K,
                default_value=dv, min_value=lo, max_value=hi))
        self.attack = mk("attack", 0.003, 0.0, 1.0)
        self.knee = mk("knee", 30.0, 0.0, 40.0)
        self.ratio = mk("ratio", 12.0, 1.0, 20.0)
        self.release = mk("release", 0.25, 0.0, 1.0)
        self.threshold = mk("threshold", -24.0, -100.0, 0.0)
        for p in self._params.values():
            p.set_automation_rate_constrained(True)
        for p, v in (("attack", attack), ("knee", knee), ("ratio", ratio),
                     ("release", release), ("threshold", threshold)):
            if getattr(self, p).default_value != v:
                getattr(self, p).set_value(v)
        self._reduction = 0.0

    @property
    def reduction(self) -> float:
        """Current gain reduction in dB (reference: :450, AtomicF32)."""
        return self._reduction

    def _validate_channel_count(self, count: int):
        if count > 2:
            raise NotSupportedError(
                "DynamicsCompressorNode channel count cannot be greater than 2")

    def _validate_channel_count_mode(self, mode: ChannelCountMode):
        if mode == ChannelCountMode.MAX:
            raise NotSupportedError(
                "DynamicsCompressorNode channel count mode cannot be 'max'")

    def output_channel_count(self, input_counts):
        return [max(1, input_counts[0])]

    def make_kernel(self, render_ctx):
        return _CompressorKernel(max(1, render_ctx.input_channel_counts[0]),
                                 render_ctx.sample_rate, render_ctx.device,
                                 param_plans=render_ctx.param_plans)

    def _on_render_state(self, state):
        self._reduction = float(state["reduction"])
