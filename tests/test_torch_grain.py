"""The port's grain reads (webaudio_tpu_torch/ops/grain_read.py) against the
JAX package's TPU kernels, on the CPU.

The JAX kernels run as the JAX suite runs them here: the Pallas kernels in
interpret mode.  The same numpy inputs go to both.  Tolerances:
- `grouped_lerp`'s plain version vs K3 (`grouped_row_lerp_v`), K4
  (`windowed_read_tpu`) and K7 (`grouped_row_lerp_pl`): within one ulp of
  the larger lerp operand, with more than half of the values bit-equal,
  the JAX suite's own bound (tests/test_grain_read.py:298-318): XLA may
  contract a product and a sum into an FMA, the port never does;
- `grain_bank`'s plain version vs K2 (`_grain_bank_fused`): 1e-6 x peak
  on benches/suite.py's sample, sin(0.05 n).  XLA contracts the playhead
  `base_f + rate * j` into an FMA, which the port (and its CUDA kernel)
  never does; that moves a lerp weight by up to an ulp of the playhead
  within the quantum (~8e-6 at j = 127), times the step between two
  neighbouring samples (<= 0.05 here), well inside the bound.  On white
  noise the same ulp moves a sample by ~1e-5, which the whole-render
  tests bound at 3e-5 (tests/test_torch_fusion.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from webaudio_tpu.ops import grain_read as jgr
from webaudio_tpu_torch.ops import grain_read as tgr

Q = 128


def _ext(rng, C, L, w):
    return rng.standard_normal((C, L + w + 2)).astype(np.float32)


def _monotone_groups(rng, R, B, g, w, L):
    """pi (R, B) int32 monotone within each g-sample group, spanning at
    most w - 3 samples, and fr (R, B) f32 in [0, 1)."""
    base = rng.integers(0, L - w, size=(R, B // g)).astype(np.int32)
    step = rng.random((R, B // g)).astype(np.float32) * ((w - 3) / g)
    pif = base[:, :, None] + np.arange(g, dtype=np.float32)[None, None] * \
        step[:, :, None]
    pi = np.floor(pif).astype(np.int32).reshape(R, B)
    fr = (pif - np.floor(pif)).astype(np.float32).reshape(R, B)
    return pi, fr


def _operand_bound(ext, pi, g, w, wrap):
    """One ulp of the larger of the two taps each output lerps."""
    R, B = pi.shape
    piq = pi.reshape(R * (B // g), g)
    w0 = np.minimum(piq[:, 0], piq[:, -1])
    loc = np.clip(piq - w0[:, None], 0, w - 2)
    if wrap:
        w0 = w0 % wrap
    idx = (w0[:, None] + loc).reshape(R, B)
    return np.spacing(np.maximum(np.abs(ext[:, idx]), np.abs(ext[:, idx + 1])))


def _port_lerp(ext, pi, fr, g, w, wrap):
    out = tgr.grouped_lerp(torch.from_numpy(ext)[None],
                           torch.from_numpy(pi)[None],
                           torch.from_numpy(fr)[None], g, w, wrap)
    return out[0].numpy()                                   # (C, R, B)


def _assert_within_an_ulp(got, want, bound):
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= bound), (float(err.max()), float(bound.max()))
    assert np.mean(got == want) > 0.5


L_TEST = 4000

# (C, g, w, R, B, wrap): 1-3 channels without a wrap and with a
# whole-buffer loop's (wrap = L, unwrapped playheads), then the JAX
# suite's other cases (group sizes, row widths, padding remainders, a
# wrap shorter than the buffer)
GROUPED = ([(C, 16, 21, 5, 2048, wrap) for C in (1, 2, 3)
            for wrap in (0, L_TEST)]
           + [(2, 8, 11, 4, 1024, 0), (2, 16, 30, 2, 1024, 500),
              (1, 8, 32, 1, 64, 0)])


def _playheads(rng, R, B, g, w, wrap):
    pi, fr = _monotone_groups(rng, R, B, g, w, L_TEST)
    if wrap == L_TEST:
        pi = pi + 3 * L_TEST     # a whole-buffer loop's unwrapped playheads
    return pi, fr


@pytest.mark.parametrize("C,g,w,R,B,wrap", GROUPED)
def test_grouped_lerp_matches_grouped_row_lerp_v(C, g, w, R, B, wrap):
    rng = np.random.default_rng(7 + C + g + wrap)
    ext = _ext(rng, C, L_TEST, w)
    pi, fr = _playheads(rng, R, B, g, w, wrap)
    want = np.asarray(jgr.grouped_row_lerp_v(
        jnp.asarray(jgr.stage_rows(ext, w)), jnp.asarray(pi),
        jnp.asarray(fr), g, w, wrap, interpret=True))
    _assert_within_an_ulp(_port_lerp(ext, pi, fr, g, w, wrap), want,
                          _operand_bound(ext, pi, g, w, wrap))


@pytest.mark.parametrize("C,g,w,R,B,wrap",
                         [c for c in GROUPED if c[0] <= 2 and c[1] <= 16])
def test_grouped_lerp_matches_grouped_row_lerp_pl(C, g, w, R, B, wrap):
    rng = np.random.default_rng(17 + C + g + wrap)
    ext = _ext(rng, C, L_TEST, w)
    pi, fr = _playheads(rng, R, B, g, w, wrap)
    want = np.asarray(jgr.grouped_row_lerp_pl(
        jnp.asarray(jgr.stage_rows(ext, w)), jnp.asarray(pi),
        jnp.asarray(fr), g, w, wrap, interpret=True))
    _assert_within_an_ulp(_port_lerp(ext, pi, fr, g, w, wrap), want,
                          _operand_bound(ext, pi, g, w, wrap))


@pytest.mark.parametrize("C", (1, 2, 3))
@pytest.mark.parametrize("wrap", (0, L_TEST))
def test_grouped_lerp_matches_windowed_read_tpu(C, wrap):
    # K4 at the window geometry of a rate-1.1 bank: the sub-block is the
    # group, the window its row
    Qs, W = jgr.pick_window(1.1, 4096)
    assert (Qs, W) == tgr.pick_window(1.1, 4096) == (128, 192)
    rng = np.random.default_rng(3 * C + wrap)
    R, B = 2, 2048
    ext = _ext(rng, C, L_TEST, W)
    pi, fr = _playheads(rng, R, B, Qs, W, wrap)
    piq = pi.reshape(-1, Qs)
    w0 = np.minimum(piq[:, 0], piq[:, -1])
    loc = np.clip(piq - w0[:, None], 0, W - 2)
    if wrap:
        w0 = w0 % wrap
    want = np.asarray(jgr.windowed_read_tpu(
        jnp.asarray(ext), jnp.asarray(w0), jnp.asarray(loc),
        jnp.asarray(fr.reshape(-1, Qs)), Qs, W, interpret=True))
    _assert_within_an_ulp(_port_lerp(ext, pi, fr, Qs, W, wrap),
                          want.reshape(C, R, B),
                          _operand_bound(ext, pi, Qs, W, wrap))


@pytest.mark.parametrize("C,g,w,R,B,wrap", GROUPED[:2] + GROUPED[6:8])
def test_grouped_lerp_equals_the_contract(C, g, w, R, B, wrap):
    # grouped_row_lerp (grain_read.py:832) is the XLA contract all three
    # kernels hold to; it is a sum of the same two products
    rng = np.random.default_rng(27 + C + g + wrap)
    ext = _ext(rng, C, L_TEST, w)
    pi, fr = _playheads(rng, R, B, g, w, wrap)
    want = np.asarray(jgr.grouped_row_lerp(
        jnp.asarray(jgr.stage_rows(ext, w)), jnp.asarray(pi),
        jnp.asarray(fr), g, w, wrap))
    _assert_within_an_ulp(_port_lerp(ext, pi, fr, g, w, wrap), want,
                          _operand_bound(ext, pi, g, w, wrap))


# the shapes the CUDA kernel's vector and scalar paths must get right:
# groups of 1 and 3 on rows whose length is not a multiple of 4, 2, 8, 16
# and 128 (the warp-shuffle group ends), 12 (a multiple of 4 that does
# not divide 128), 1-3 channels, with and without a whole-buffer wrap
EDGE_GROUPS = [(1, 4, 1001), (1, 4, 1024), (2, 5, 1026), (3, 7, 999),
               (8, 12, 2048), (12, 16, 1020), (16, 21, 2048),
               (128, 192, 2048)]


@pytest.mark.parametrize("g,w,B", EDGE_GROUPS)
@pytest.mark.parametrize("C", (1, 2, 3))
@pytest.mark.parametrize("wrap", (0, L_TEST))
def test_grouped_lerp_edge_shapes_match_grouped_row_lerp(g, w, B, C, wrap):
    rng = np.random.default_rng(1000 + 7 * g + B + C + wrap)
    ext = _ext(rng, C, L_TEST, w)
    pi, fr = _playheads(rng, 2, B, g, w, wrap)
    want = np.asarray(jgr.grouped_row_lerp(
        jnp.asarray(jgr.stage_rows(ext, w)), jnp.asarray(pi),
        jnp.asarray(fr), g, w, wrap))
    _assert_within_an_ulp(_port_lerp(ext, pi, fr, g, w, wrap), want,
                          _operand_bound(ext, pi, g, w, wrap))


def test_grouped_lerp_instances():
    # (I, C, Lx) buffers with one shared (1, R, B) playhead, and a shared
    # buffer with per-instance playheads: each instance is its own call
    rng = np.random.default_rng(5)
    g, w, L = 16, 21, 3000
    exts = np.stack([_ext(rng, 2, L, w) for _ in range(3)])
    pis, frs = zip(*[_monotone_groups(rng, 2, 512, g, w, L) for _ in range(3)])
    pis, frs = np.stack(pis), np.stack(frs)
    both = tgr.grouped_lerp(torch.from_numpy(exts), torch.from_numpy(pis[:1]),
                            torch.from_numpy(frs[:1]), g, w).numpy()
    per = tgr.grouped_lerp(torch.from_numpy(exts[:1]), torch.from_numpy(pis),
                           torch.from_numpy(frs), g, w).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            both[i], _port_lerp(exts[i], pis[0], frs[0], g, w, 0))
        np.testing.assert_array_equal(
            per[i], _port_lerp(exts[0], pis[i], frs[i], g, w, 0))


def _bank_fields(rng, K, nq, L, rmax, frame0, C, local=False):
    """Per-quantum lane fields like the fused bank's: grains that start
    and stop inside quanta, quanta without a grain, playheads that begin
    before sample 0 and run past the buffer end.  `local` starts each
    quantum's grain near that quantum (anywhere in the block otherwise)."""
    B = nq * Q
    ok = (rng.random((K, nq)) > 0.15).astype(np.int32)
    if local:
        sv = (frame0 + Q * np.arange(nq) + rng.integers(-200, Q, (K, nq))) \
            .astype(np.int32)
    else:
        sv = frame0 + rng.integers(-300, B, (K, nq)).astype(np.int32)
    ev = sv + rng.integers(0, 600, (K, nq)).astype(np.int32)
    base = rng.integers(-150, L + 20, (K, nq))
    base[:, ::4] = L - 60                       # grains crossing the end
    base[:, 1::7] = -40                         # and the start
    base_i = base.astype(np.int32)
    base_f = rng.random((K, nq)).astype(np.float32)
    rate = rng.uniform(rmax / 1.2, rmax, (K, nq)).astype(np.float32)
    gain = rng.uniform(-0.2, 1.3, (K, B)).astype(np.float32)
    # benches/suite.py's synthetic sample, sin(0.05 n), per channel phase
    n = np.arange(L)[None] + 977 * np.arange(C)[:, None]
    data = np.sin(n * 0.05).astype(np.float32)
    return ok, sv, ev, base_i, base_f, rate, gain, data


def _edge(data):
    return (2.0 * data[:, -1] - data[:, -2]).astype(np.float32)


def _port_bank(ok, sv, ev, base_i, base_f, rate, gain, data, w, frame0,
               gl0, gl1):
    C, L = data.shape
    ext = np.zeros((C, L + w + 2), np.float32)
    ext[:, :L] = data
    ext[:, L] = _edge(data)
    t = [torch.from_numpy(x)[None] for x in (ext, _edge(data), ok, sv, ev,
                                             base_i, base_f, rate, gain)]
    return tgr.grain_bank(*t, torch.tensor(frame0), L, gl0, gl1)[0].numpy()


@pytest.mark.parametrize("C,rmax,nq,frame0", [(2, 1.0995, 16, 0),
                                               (1, 1.37, 9, 441088 - 9 * 128),
                                               (2, 0.52, 12, 128)])
def test_grain_bank_matches_grain_bank_fused(C, rmax, nq, frame0):
    rng = np.random.default_rng(int(rmax * 1000) + C)
    K, L = 5, 2600
    g, w = tgr.pick_group(rmax, C, L, nq * Q, wide=True)
    assert (g, w) == jgr.pick_group(rmax, C, L, nq * Q, wide=True)
    ok, sv, ev, base_i, base_f, rate, gain, data = _bank_fields(
        rng, K, nq, L, rmax, frame0, C)
    gl0, gl1 = 0.0, 1.0
    got = _port_bank(ok, sv, ev, base_i, base_f, rate, gain, data, w,
                     frame0, gl0, gl1)

    ext = np.zeros((C, L + w + 2), np.float32)
    ext[:, :L] = data
    ext[:, L] = _edge(data)
    rows3 = jgr.stage_rows(ext, w)
    N, Cw = rows3.shape[0], C * w
    flat = np.zeros((N, -(-Cw // 8) * 8), np.float32)
    flat[:, :Cw] = rows3.reshape(N, Cw)
    t = frame0 + np.arange(nq * Q, dtype=np.int32)
    want = np.asarray(jgr._grain_bank_fused(
        jnp.asarray(flat), jnp.asarray(t), jnp.asarray(ok.astype(np.float32)),
        jnp.asarray(sv), jnp.asarray(ev), jnp.asarray(base_i),
        jnp.asarray(base_f), jnp.asarray(rate), jnp.asarray(gain),
        jnp.asarray(_edge(data)), g=g, w=w, L=L, Q=Q, gl0=gl0, gl1=gl1,
        interpret=True))
    assert got.shape == want.shape == (C, nq * Q)
    peak = float(np.abs(want).max())
    assert peak > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)


def _jax_bank(ok, sv, ev, base_i, base_f, rate, gain, data, g, w, frame0,
              gl0, gl1):
    """K2 in interpret mode on the staged rows of `data`."""
    C, L = data.shape
    nq = ok.shape[1]
    ext = np.zeros((C, L + w + 2), np.float32)
    ext[:, :L] = data
    ext[:, L] = _edge(data)
    rows3 = jgr.stage_rows(ext, w)
    N, Cw = rows3.shape[0], C * w
    flat = np.zeros((N, -(-Cw // 8) * 8), np.float32)
    flat[:, :Cw] = rows3.reshape(N, Cw)
    t = frame0 + np.arange(nq * Q, dtype=np.int32)
    return np.asarray(jgr._grain_bank_fused(
        jnp.asarray(flat), jnp.asarray(t), jnp.asarray(ok.astype(np.float32)),
        jnp.asarray(sv), jnp.asarray(ev), jnp.asarray(base_i),
        jnp.asarray(base_f), jnp.asarray(rate), jnp.asarray(gain),
        jnp.asarray(_edge(data)), g=g, w=w, L=L, Q=Q, gl0=gl0, gl1=gl1,
        interpret=True))


# the shapes the CUDA kernel's warp-per-quantum indexing must get right:
# one and three quanta, the 400-grain block's 3,446; one lane, 9 lanes
# (two load chunks) and 33 (more lanes than a warp has threads)
@pytest.mark.parametrize("nq,K", [(1, 1), (3, 9), (3, 33), (1, 33),
                                  (3446, 1), (3446, 5), (3446, 9)])
def test_grain_bank_edge_shapes_match_grain_bank_fused(nq, K):
    rng = np.random.default_rng(nq * 100 + K)
    C, L, rmax, frame0 = 2, 2600, 1.0995, 128 * 3
    g, w = tgr.pick_group(rmax, C, L, nq * Q, wide=True)
    fields = _bank_fields(rng, K, nq, L, rmax, frame0, C, local=True)
    got = _port_bank(*fields, w, frame0, 0.0, 1.0)
    want = _jax_bank(*fields, g, w, frame0, 0.0, 1.0)
    assert got.shape == want.shape == (C, nq * Q)
    peak = float(np.abs(want).max())
    assert peak > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)


# which of (ext, the lane fields, gain) carry the instance axis
@pytest.mark.parametrize("axes", [(False, True, True), (True, False, True),
                                  (True, True, False), (False, False, True)])
def test_grain_bank_mixed_instance_axes_match_grain_bank_fused(axes):
    rng = np.random.default_rng(sum(a << n for n, a in enumerate(axes)))
    I, K, nq, L, rmax, C, frame0 = 3, 4, 5, 1500, 1.2, 2, 0
    g, w = tgr.pick_group(rmax, C, L, nq * Q, wide=True)
    per = [_bank_fields(rng, K, nq, L, rmax, frame0, C, local=True)
           for _ in range(I)]
    scale = np.float32([1.0, 0.5, -0.75])     # one buffer per instance
    ext_i, fld_i, gain_i = axes
    datas = [per[i][7] * (scale[i] if ext_i else 1) for i in range(I)]
    insts = [tuple(per[i if fld_i else 0][:6]) + (per[i if gain_i else 0][6],)
             + (datas[i if ext_i else 0],) for i in range(I)]

    def stack(n, on):
        return torch.from_numpy(np.stack([insts[i][n] for i in range(
            I if on else 1)]))

    ext = np.zeros((I if ext_i else 1, C, L + w + 2), np.float32)
    ext[:, :, :L] = np.stack(datas[:ext.shape[0]])
    edge = np.stack([_edge(d) for d in datas[:ext.shape[0]]])
    ext[:, :, L] = edge
    got = tgr.grain_bank(torch.from_numpy(ext), torch.from_numpy(edge),
                         *[stack(n, fld_i) for n in range(6)],
                         stack(6, gain_i), torch.tensor(frame0), L, 0.0,
                         1.0).numpy()
    assert got.shape == (I, C, nq * Q)
    for i in range(I):
        want = _jax_bank(*insts[i], g, w, frame0, 0.0, 1.0)
        peak = float(np.abs(want).max())
        assert peak > 0.05
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6 * peak)


def test_grain_bank_sums_lanes_in_ascending_order():
    # K2 adds lane k's value to the running sum of lanes 0..k-1, in f32;
    # so does the plain version
    rng = np.random.default_rng(9)
    K, nq, L = 4, 4, 1000
    ok, sv, ev, base_i, base_f, rate, gain, data = _bank_fields(
        rng, K, nq, L, 1.0, 0, 2)
    ok[:] = 1
    sv[:], ev[:] = -10**6, 10**6
    base_i[:] = rng.integers(0, L - 200, (K, nq))
    whole = _port_bank(ok, sv, ev, base_i, base_f, rate, gain, data, 20, 0,
                       -9.0, 9.0)
    acc = None
    for k in range(K):
        one = _port_bank(ok[k:k + 1], sv[k:k + 1], ev[k:k + 1],
                         base_i[k:k + 1], base_f[k:k + 1], rate[k:k + 1],
                         gain[k:k + 1], data, 20, 0, -9.0, 9.0)
        acc = one if acc is None else (acc + one).astype(np.float32)
    np.testing.assert_array_equal(whole, acc)


def _worst_loc(rate, g, w, base_i, base_f, L):
    """The largest and smallest unclipped in-row offset piv - w0 of one
    lane's quantum, with the kernel's f32 playhead: delta = base_f + rate
    * j, piv = clip(base_i + floor(delta), 0, L - 1), w0 = min of piv at
    the group's two ends."""
    j = np.arange(Q, dtype=np.float32)
    delta = (np.float32(base_f) + np.float32(rate) * j).astype(np.float32)
    piv = np.clip(base_i + np.floor(delta).astype(np.int64), 0, L - 1)
    grp = piv.reshape(Q // g, g)
    w0 = np.minimum(grp[:, 0], grp[:, -1])
    loc = grp - w0[:, None]
    return int(loc.max()), int(loc.min())


@pytest.mark.parametrize("wide", (True, False))
def test_grain_row_clip_never_binds(wide):
    """The premise of K2 reading the buffer directly: the TPU kernel reads
    each lane through a w-sample row from w0 = min(piv at the group's two
    ends) and clips loc = piv - w0 to [0, w - 2].  With w = ceil(g *
    rmax) + 3 and an f32 playhead that is monotone within a quantum, the
    clip never binds, so w0 + loc == piv.  Swept over rates up to
    pick_group's bound (both signs) and playheads starting before sample
    0, inside, and at the buffer's last sample."""
    rng = np.random.default_rng(2026 + wide)
    L = 5000
    tops = []
    for rmax in np.linspace(0.01, 6.0, 600):
        g, w = tgr.pick_group(rmax, 2, L, 1024, wide=wide)
        if not g:
            continue
        tops.append(rmax)
        for _ in range(6):
            rate = rmax * rng.uniform(0.0, 1.0) * rng.choice((-1.0, 1.0))
            rate = rmax if rng.random() < 0.3 else rate
            base_f = np.float32(rng.random())
            for base_i in (rng.integers(-300, 5), rng.integers(5, L - 5),
                           L - 1, rng.integers(L - 140, L + 5)):
                hi, lo = _worst_loc(rate, g, w, int(base_i), base_f, L)
                assert 0 <= lo and hi <= w - 2, (rmax, rate, g, w, base_i)
    # the sweep reached the largest rate each geometry admits
    assert max(tops) > (5.5 if wide else 3.5)


@pytest.mark.parametrize("rmax", (0.3, 1.0, 1.0995, 1.4, 2.0, 3.6, 4.0, 5.6,
                                  6.0))
@pytest.mark.parametrize("block", (128, 4096, 441088))
def test_geometry_helpers_match_jax(rmax, block):
    for C, L in ((1, 1000), (2, 88200), (3, 5_000_000)):
        for wide in (False, True):
            assert tgr.pick_group(rmax, C, L, block, wide=wide) == \
                jgr.pick_group(rmax, C, L, block, wide=wide)
    assert tgr.pick_window(rmax, block) == jgr.pick_window(rmax, block)
    assert tgr.RENDER_QUANTUM_MAX_GROUP == jgr.RENDER_QUANTUM_MAX_GROUP


def test_wrappers_take_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(1)
    ext = torch.from_numpy(_ext(rng, 2, 100, 21))[None]
    pi = torch.zeros((1, 1, 32), dtype=torch.int32)
    fr = torch.zeros((1, 1, 32))
    before = tgr.grouped_lerp.launches
    out = tgr.grouped_lerp(ext, pi, fr, 16, 21)
    assert tgr.grouped_lerp.launches == before        # no kernel launched
    assert out.shape == (1, 2, 1, 32)
    torch.testing.assert_close(out[0, :, 0], ext[0, :, :1].expand(2, 32))


def test_wrappers_take_offset_views():
    # views that start one float past a 16-byte boundary (the CUDA
    # kernels' scalar path) give the same values
    rng = np.random.default_rng(11)
    g, w, L, B = 16, 21, 900, 256
    ext = torch.from_numpy(_ext(rng, 2, L, w))[None]
    pi, fr = _monotone_groups(rng, 2, B, g, w, L)
    pis = torch.from_numpy(np.concatenate([[0], pi.ravel()]).astype(np.int32))
    frs = torch.from_numpy(np.concatenate([[0], fr.ravel()]).astype(
        np.float32))
    out = tgr.grouped_lerp(ext, pis[1:].view(1, 2, B), frs[1:].view(1, 2, B),
                           g, w)
    np.testing.assert_array_equal(out[0].numpy(),
                                  _port_lerp(ext[0].numpy(), pi, fr, g, w, 0))

    K, nq, C = 3, 2, 2
    fields = _bank_fields(rng, K, nq, L, 1.0, 0, C, local=True)
    gain = torch.from_numpy(np.concatenate([[0], fields[6].ravel()]).astype(
        np.float32))[1:].view(1, K, nq * Q)
    ext2 = np.zeros((1, C, L + 41), np.float32)
    ext2[0, :, :L] = fields[7]
    ext2[0, :, L] = _edge(fields[7])
    out2 = tgr.grain_bank(torch.from_numpy(ext2),
                          torch.from_numpy(_edge(fields[7]))[None],
                          *[torch.from_numpy(x)[None] for x in fields[:6]],
                          gain, torch.tensor(0), L, 0.0, 1.0)
    np.testing.assert_array_equal(out2[0].numpy(),
                                  _port_bank(*fields, 40, 0, 0.0, 1.0))
