"""The port's tensor ops (webaudio_tpu_torch/ops/) against the JAX
package's, on the CPU, from the same numpy inputs."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from webaudio_tpu.ops import bufread as jbufread
from webaudio_tpu.ops import fft_conv as jfft
from webaudio_tpu.ops import mixing as jmixing
from webaudio_tpu.ops import recurrence as jrec
from webaudio_tpu_torch.ops import bufread as tbufread
from webaudio_tpu_torch.ops import fft_conv as tfft
from webaudio_tpu_torch.ops import mixing as tmixing
from webaudio_tpu_torch.ops import recurrence as trec

PORT = pathlib.Path(__file__).resolve().parent.parent / "webaudio_tpu_torch"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("ir_len,block,partition", [
    (300, 1024, 256),      # K = 2: the delay line carries one spectrum
    (5000, 2048, 1024),    # K = 5 > J: older spectra cross the boundary
    (100, 512, 512),       # K = 1: no carried spectra, only the tail
])
def test_partitioned_conv_two_blocks_carry_state(ir_len, block, partition):
    rng = np.random.default_rng(ir_len)
    C = 2
    ir = (rng.standard_normal(ir_len) * np.exp(-np.arange(ir_len) / 200.0)
          ).astype(np.float32)
    x = rng.standard_normal((C, 2 * block)).astype(np.float32)
    h = tfft.partition_ir(ir, partition)
    np.testing.assert_array_equal(h, jfft.partition_ir(ir, partition))
    K = h.shape[1]

    jst = jfft.PartitionedConvState.init(C, K, partition)
    tst = tfft.init_state(C, K, partition, "cpu")
    jys, tys = [], []
    for b in range(2):
        xb = x[:, b * block:(b + 1) * block]
        jst, jy = jfft.partitioned_conv_block(jst, jnp.asarray(xb),
                                              jnp.asarray(h), partition)
        tst, ty = tfft.partitioned_conv_block(tst, _t(xb), _t(h), partition)
        jys.append(np.asarray(jy))
        tys.append(ty.numpy())
    direct = np.stack([np.convolve(x[c].astype(np.float64), ir)[:2 * block]
                       for c in range(C)])
    got = np.concatenate(tys, axis=1)
    scale = np.abs(direct).max()
    np.testing.assert_allclose(got, np.concatenate(jys, axis=1),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got, direct, atol=1e-5 * scale)
    np.testing.assert_allclose(tst["spectra"].numpy(),
                               np.asarray(jst["spectra"]), atol=1e-3)
    np.testing.assert_array_equal(tst["tail"].numpy(), np.asarray(jst["tail"]))
    assert tst["spectra"].dtype == torch.complex64


def test_partitioned_conv_windowed_branch_matches_unrolled():
    # K * J > 512 takes the windowed einsum; compare with the JAX package
    rng = np.random.default_rng(5)
    partition, block = 128, 128 * 64
    ir = (rng.standard_normal(128 * 9) * 0.1).astype(np.float32)
    h = tfft.partition_ir(ir, partition)
    assert h.shape[1] * (block // partition) > 512
    x = rng.standard_normal((1, block)).astype(np.float32)
    _, jy = jfft.partitioned_conv_block(
        jfft.PartitionedConvState.init(1, h.shape[1], partition),
        jnp.asarray(x), jnp.asarray(h), partition)
    _, ty = tfft.partitioned_conv_block(
        tfft.init_state(1, h.shape[1], partition, "cpu"), _t(x), _t(h), partition)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               atol=1e-5 * np.abs(np.asarray(jy)).max())


@pytest.mark.parametrize("B", [1, 2, 7, 4096])
def test_recurrence_2nd_order_f64(B):
    rng = np.random.default_rng(B)
    C = 2
    # resonant, slowly moving poles: r = 0.995 at a drifting angle
    theta = np.linspace(0.05, 0.4, B)
    a1 = -2 * 0.995 * np.cos(theta)
    a2 = np.full(B, 0.995 ** 2)
    f = rng.standard_normal((C, B))
    y1, y2 = rng.standard_normal((C, 1)), rng.standard_normal((C, 1))
    want = np.stack([np.asarray(jrec.recurrence_2nd_order(
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(f[c]),
        jnp.asarray(y1[c, 0]), jnp.asarray(y2[c, 0]))) for c in range(C)])
    got = trec.recurrence_2nd_order(_t(a1), _t(a2), _t(f), _t(y1), _t(y2))
    assert got.dtype == torch.float64
    # exact sequential oracle
    seq = np.zeros((C, B))
    for c in range(C):
        p1, p2 = y1[c, 0], y2[c, 0]
        for n in range(B):
            yn = f[c, n] - a1[n] * p1 - a2[n] * p2
            seq[c, n], p1, p2 = yn, yn, p1
    scale = np.abs(seq).max()
    np.testing.assert_allclose(got.numpy(), seq, atol=1e-9 * scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9 * scale)


def test_biquad_forcing_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    co = [rng.standard_normal(300).astype(np.float32) for _ in range(3)]
    x1 = rng.standard_normal((2, 1)).astype(np.float32)
    x2 = rng.standard_normal((2, 1)).astype(np.float32)
    want = jrec.biquad_forcing(jnp.asarray(x), *map(jnp.asarray, co),
                               jnp.asarray(x1), jnp.asarray(x2))
    got = trec.biquad_forcing(_t(x), *map(_t, co), _t(x1), _t(x2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_iir_impulse_response_is_the_same_host_code():
    b, a = [0.2, 0.4, 0.2], [1.0, -0.5, 0.3]
    np.testing.assert_array_equal(trec.iir_impulse_response(b, a),
                                  jrec.iir_impulse_response(b, a))


@pytest.mark.parametrize("c_in,c_out,interp", [
    (1, 2, "speakers"), (2, 1, "speakers"), (2, 6, "speakers"),
    (6, 2, "speakers"), (4, 2, "speakers"), (2, 4, "discrete"),
    (3, 1, "discrete"), (2, 2, "speakers"),
])
def test_mix_matches_jax(c_in, c_out, interp):
    rng = np.random.default_rng(c_in * 10 + c_out)
    sig = rng.standard_normal((c_in, 256)).astype(np.float32)
    want = jmixing.mix(jnp.asarray(sig), c_out,
                       jmixing.ChannelInterpretation(interp))
    got = tmixing.mix(_t(sig), c_out, tmixing.ChannelInterpretation(interp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_sum_inputs_matches_jax():
    rng = np.random.default_rng(2)
    sigs = [rng.standard_normal((c, 128)).astype(np.float32) for c in (1, 2, 6)]
    sp = tmixing.ChannelInterpretation.SPEAKERS
    want = jmixing.sum_inputs([jnp.asarray(s) for s in sigs], 2,
                              jmixing.ChannelInterpretation.SPEAKERS, 128)
    got = tmixing.sum_inputs([_t(s) for s in sigs], 2, sp, 128, "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    silent = tmixing.sum_inputs([], 3, sp, 64, "cpu")
    assert silent.shape == (3, 64) and silent.dtype == torch.float32
    assert not silent.any()


def test_gather_pairs_matches_jax():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((2, 50)).astype(np.float32)
    rows = tbufread.pair_rows(data)
    np.testing.assert_array_equal(rows, jbufread.pair_rows(data))
    for loop, wrap in ((False, 0), (True, 7)):
        np.testing.assert_array_equal(tbufread.edge_vals(data, loop, wrap),
                                      jbufread.edge_vals(data, loop, wrap))
    idx = rng.integers(0, 50, size=(3, 40))
    ja, jb = jbufread.gather_pairs(jnp.asarray(rows), jnp.asarray(idx, jnp.int32))
    ta, tb = tbufread.gather_pairs(_t(rows), _t(idx))
    assert ta.shape == (2, 3, 40)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    valid = idx < 49          # b is undefined at the last row
    np.testing.assert_array_equal(tb.numpy()[:, valid], np.asarray(jb)[:, valid])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "webaudio_tpu"), \
                f"{path.relative_to(PORT.parent)} imports {mod}"


def test_chip_smoke_never_imports_jax_or_the_jax_package():
    path = PORT.parent / "chip_smoke.py"
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "webaudio_tpu"), \
            f"chip_smoke.py imports {mod}"
