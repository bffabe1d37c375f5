"""The port's curve lookup (webaudio_tpu_torch/ops/curve_kernel.py) against
the JAX package's WaveShaper lookups, on the CPU.

The plain version must equal the JAX contract `_apply_curve_gather` bit
for bit.  The TPU kernel K1 (`curve_lookup_tpu_v3`, run in interpret mode
as tests/test_grain_read.py runs it) is not bit-equal to that contract:
it rounds lo + f to f32 before building its triangular hat and sums
through a dot, so it is held to 1e-6 absolute (measured 6e-8 here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from webaudio_tpu.nodes.waveshaper import _apply_curve_gather
from webaudio_tpu.ops.curve_kernel import curve_lookup_tpu_v3
from webaudio_tpu_torch import KernelError
from webaudio_tpu_torch.ops import curve_kernel as ck

# 8192 the longest curve a table block stages in shared memory, 8193 one
# more, 44100 MDN's distortion curve
CURVE_LENGTHS = (2, 256, 4096, 8192, 8193, 44100, 65536)


def _inputs(seed=7, m=6000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, size=m).astype(np.float32)
    # the edges: NaN, infinities, the exact ends and just inside them
    x[:8] = [np.nan, np.inf, -np.inf, -1.0, 1.0,
             np.nextafter(np.float32(-1), np.float32(0)),
             np.nextafter(np.float32(1), np.float32(0)), 0.0]
    return x


def _curve(n, seed=3):
    rng = np.random.default_rng(seed + n)
    return (np.tanh(np.linspace(-2, 2, n))
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n", CURVE_LENGTHS)
def test_plain_version_equals_apply_curve_gather(n):
    x, curve = _inputs(), _curve(n)
    ref = np.asarray(_apply_curve_gather(jnp.asarray(curve), jnp.asarray(x)))
    got = ck.curve_lookup_reference(torch.from_numpy(curve),
                                    torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", CURVE_LENGTHS)
def test_plain_version_matches_tpu_kernel_interpret(n):
    x, curve = _inputs(seed=11, m=3000), _curve(n)
    segk = 127                 # the table geometry waveshaper.py stages
    nseg = -(-n // segk)
    npad = nseg * segk
    cpad = np.concatenate([curve, np.broadcast_to(curve[-1], (npad + 1 - n,))])
    table = np.zeros((nseg, segk + 1), np.float32)
    table[:, :segk] = cpad[:npad].reshape(nseg, segk)
    table[:, segk] = cpad[segk::segk][:nseg]
    ref = np.asarray(curve_lookup_tpu_v3(jnp.asarray(x), jnp.asarray(table),
                                         n, segk, interpret=True))
    got = ck.curve_lookup_reference(torch.from_numpy(curve),
                                    torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    x, curve = _inputs(m=512), _curve(256)
    before = ck.curve_lookup.launches
    got = ck.curve_lookup(torch.from_numpy(curve), torch.from_numpy(x))
    want = ck.curve_lookup_reference(torch.from_numpy(curve), torch.from_numpy(x))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert ck.curve_lookup.launches == before


def test_wrapper_refuses_mixed_devices():
    curve = torch.from_numpy(_curve(16))
    with pytest.raises(KernelError):
        ck.curve_lookup(curve, torch.zeros(4, device="meta"))


def test_half_range_is_rounded_to_f32_like_jax():
    # (n-1)/2 for large odd n-1 is not an f32; JAX rounds the weak-typed
    # Python float to f32 before the product, and so must the port
    n = 2**25 + 2
    assert ck._half_nm1(n) == float(np.float32((n - 1) / 2.0))
    assert ck._half_nm1(n) != (n - 1) / 2.0


# the launch plan, on an H100's limits: 132 SMs, 49,152 bytes of shared
# memory a block (without opting in to more)
SMS, SMEM = 132, 49152


def test_longest_staged_curve_fits_a_block_without_opting_in():
    assert ck.staged_bytes(ck._STAGE_MAX_POINTS) <= SMEM
    # the barrier, and a bulk copy's 16-byte units wherever the curve starts
    assert ck.staged_bytes(2048) == 16 + 4 * 2048 + 32


@pytest.mark.parametrize("n,m,grid", [
    (2048, 2 * 262144, (1056, 1)),        # the slice: 8 blocks of 256 a SM
    (2048, 2 * 1048576, (1056, 1)),       # one wave, striding
    (44100, 2 * 262144, (1056, 1)),
    (65536, 2 * 262144, (1056, 1)),
    (2048, 5, (1, 1)),
])
def test_launch_plan_for_one_curve(n, m, grid):
    # one curve gathers through the read-only cache, whatever its length
    p = ck.launch_plan(n, m, 1, SMS, SMEM)
    assert (p.mode, p.grid, p.threads, p.smem_bytes) == ("global", grid, 256, 0)


@pytest.mark.parametrize("R,row_len,n,smem,mode,grid", [
    # a MixedGraphBatch shaper bucket of per-instance curves: 2 blocks of
    # 512 a SM, 8 a row
    (32, 2 * 16384, 2048, SMEM, "shared", (8, 32)),
    (3, 2 * 4099, 2048, SMEM, "shared", (5, 3)),  # rows not a multiple of 4
    (2, 4, 2, SMEM, "shared", (1, 2)),            # the shortest curve
    (4, 2 ** 20, 8192, SMEM, "shared", (66, 4)),  # the longest staged curve
    (4, 2 ** 20, 8193, SMEM, "cached", (33, 4)),  # 1 block of 1024 a SM
    (32, 2 * 16384, 65536, SMEM, "cached", (4, 32)),
    (1024, 256, 2048, SMEM, "shared", (1, 264)),  # more rows than the wave
    (70000, 4, 2048, SMEM, "shared", (1, 264)),
    # a card whose blocks cannot hold the staged curve takes the cache
    (32, 2 * 16384, 4096, 16384, "cached", (4, 32)),
])
def test_launch_plan_for_a_table(R, row_len, n, smem, mode, grid):
    p = ck.launch_plan(n, R * row_len, R, SMS, smem)
    assert (p.mode, p.grid) == (mode, grid)
    assert p.threads == (512 if mode == "shared" else 1024)
    assert p.smem_bytes == (ck.staged_bytes(n) if mode == "shared" else 0)


@pytest.mark.parametrize("n,R,mode,threads,grid", [
    (2048, 1, "global", 256, (100, 1)),
    (2048, 4, "shared", 512, (25, 4)),
    (8193, 4, "cached", 1024, (25, 4)),
])
def test_occupancy_caps_the_wave(n, R, mode, threads, grid):
    asked = []

    def resident(*args):
        asked.append(args)
        return 100

    p = ck.launch_plan(n, R * 2 ** 20, R, SMS, SMEM, resident)
    assert (p.mode, p.threads, p.grid) == (mode, threads, grid)
    assert asked == [(mode, threads, p.smem_bytes)]
