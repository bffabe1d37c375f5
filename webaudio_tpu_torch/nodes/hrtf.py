"""HRTF panning model: binaural rendering from an HRIR sphere.

reference: src/node/panner.rs:39-69 + the `hrtf` crate (mrDIMAS/hrtf) with
the IRCAM LISTEN IRC_1003_C sphere (the JAX package's
webaudio_tpu/resources/IRC_1003_C.bin, read where it is: magic 'HRIR', u32
sample rate, u32 ir length, u32 vertex count, u32 index count, faces, then
per vertex [xyz f32, left ir, right ir]).  Ported from
`webaudio_tpu/nodes/hrtf.py`.

Host side (numpy, as in JAX): the vertex HRIRs are resampled to the
context rate, cut into 128-frame partitions and staged as spectra
(V, 2, K, P+1); the sphere's ray-triangle barycentric lookup is baked into
an (azimuth, elevation) grid of 3 vertex ids and weights.  On the device,
per render quantum: the k-rate direction (the quantum's first sample)
picks a grid cell, the 3 vertex spectra are gathered and weighted (the
JAX package's (nq, V) one-hot matmul stood in for a gather, slow on the
TPU), the input runs through a per-quantum frequency-domain delay line
(256-point rfft/irfft on cuFFT, where JAX used DFT matmuls for the MXU),
and the output crossfades from the previous quantum's HRIR to the new one
while the distance gain is lerped (the hrtf crate's semantics).  Every
step is f32 elementwise, FFT or gather: nothing goes through TF32.
"""

from __future__ import annotations

import functools
import os
import struct

import numpy as np
import torch

from ..constants import RENDER_QUANTUM_SIZE
from .panner import _SpatialKernel

HRIR_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "webaudio_tpu", "resources", "IRC_1003_C.bin")
PARTITION = RENDER_QUANTUM_SIZE  # per-quantum convolution chunks


@functools.lru_cache(maxsize=None)
def load_hrir_sphere(sample_rate: float, path: str = HRIR_PATH):
    """Parse and resample the HRIR sphere, host side, cached per rate
    (the analog of load_hrtf_processor's OnceLock cache, panner.rs:39-69).
    Returns (positions (V, 3), faces (F, 3), spectra (V, 2, K, P+1)
    complex64, K), shared by every caller at that rate."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"HRIR":
        raise ValueError(f"{path} is not an HRIR sphere")
    src_rate, ir_len, n_vert, n_idx = struct.unpack_from("<IIII", data, 4)
    off = 20
    faces = np.frombuffer(data, dtype="<u4", count=n_idx, offset=off)
    faces = faces.reshape(-1, 3).astype(np.int32)
    off += 4 * n_idx
    stride = 3 + 2 * ir_len
    verts = np.frombuffer(data, dtype="<f4", count=n_vert * stride, offset=off)
    verts = verts.reshape(n_vert, stride)
    positions = verts[:, :3].copy()
    left = verts[:, 3:3 + ir_len].copy()
    right = verts[:, 3 + ir_len:].copy()

    # resample the IRs to the context rate (linear interpolation, like
    # AudioBuffer.resample)
    if sample_rate != src_rate:
        ratio = sample_rate / src_rate
        new_len = int(np.ceil(ir_len * ratio))
        pos = np.arange(new_len, dtype=np.float64) / ratio
        k = np.minimum(np.floor(pos).astype(np.int64), ir_len - 1)
        k1 = np.minimum(k + 1, ir_len - 1)
        frac = (pos - k).astype(np.float32)
        left = (left[:, k] * (1 - frac) + left[:, k1] * frac).astype(np.float32)
        right = (right[:, k] * (1 - frac) + right[:, k1] * frac).astype(np.float32)

    # partition into per-quantum chunks and their spectra
    P = PARTITION
    L = left.shape[1]
    K = -(-L // P)
    padded = np.zeros((n_vert, 2, K * P), np.float32)
    padded[:, 0, :L] = left
    padded[:, 1, :L] = right
    z = np.zeros((n_vert, 2, K, 2 * P), np.float32)
    z[..., :P] = padded.reshape(n_vert, 2, K, P)
    spectra = np.fft.rfft(z, axis=-1).astype(np.complex64)  # (V, 2, K, P+1)
    return positions, faces, spectra, K


@functools.lru_cache(maxsize=None)
def bake_direction_grid(sample_rate: float, az_bins: int = 256,
                        el_bins: int = 128, path: str = HRIR_PATH):
    """The (azimuth, elevation) -> (3 vertex ids, barycentric weights)
    lookup grid, host side: a numpy ray-triangle test of every cell's
    direction against every face (~1.4 degree cells, far below the
    sphere's 15 degree HRIR spacing).  Returns (vids (az, el, 3) int32,
    weights (az, el, 3) f32, az_bins, el_bins), shared by every caller."""
    positions, faces, _, _ = load_hrir_sphere(sample_rate, path)
    az = (np.arange(az_bins) + 0.5) / az_bins * 2 * np.pi - np.pi
    el = (np.arange(el_bins) + 0.5) / el_bins * np.pi - np.pi / 2
    azg, elg = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.sin(azg) * np.cos(elg),
                  np.sin(elg),
                  np.cos(azg) * np.cos(elg)], axis=-1).reshape(-1, 3)

    a = positions[faces[:, 0]]
    b = positions[faces[:, 1]]
    c = positions[faces[:, 2]]
    e1 = b - a
    e2 = c - a
    pvec = np.cross(d[:, None, :], e2[None, :, :])
    det = np.einsum("nfk,fk->nf", pvec, e1)
    inv_det = np.where(np.abs(det) > 1e-9, 1.0 / det, 0.0)
    tvec = -a[None, :, :]
    u = np.einsum("nfk,nfk->nf", tvec, pvec) * inv_det
    qvec = np.cross(tvec, e1[None, :, :])
    v = np.einsum("nfk,nk->nf", qvec, d) * inv_det
    t = np.einsum("nfk,fk->nf", qvec, e2) * inv_det
    eps = 1e-5
    hit = (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps) & (t > 0)
    score = np.where(hit, t, np.inf)
    fidx = np.argmin(score, axis=1)
    nn = np.arange(len(d))
    uu = np.where(np.isfinite(score[nn, fidx]), u[nn, fidx], 0.0)
    vv = np.where(np.isfinite(score[nn, fidx]), v[nn, fidx], 0.0)
    w = np.stack([1 - uu - vv, uu, vv], axis=1).astype(np.float32)
    vids = faces[fidx].astype(np.int32)
    return (vids.reshape(az_bins, el_bins, 3),
            w.reshape(az_bins, el_bins, 3), az_bins, el_bins)


def grid_cells(azimuth, elevation, az_bins: int, el_bins: int):
    """Per-quantum grid cells of directions in degrees (f32): the angles in
    radians, then a truncating cast and a clip, as the JAX kernel does
    (webaudio_tpu/nodes/hrtf.py:207-223).  Returns int64 (az_i, el_i)."""
    az = azimuth * (np.pi / 180.0)
    el = elevation * (np.pi / 180.0)
    az_i = torch.clamp(((az / (2 * np.pi) + 0.5) * az_bins).to(torch.int64),
                       0, az_bins - 1)
    el_i = torch.clamp(((el / np.pi + 0.5) * el_bins).to(torch.int64),
                       0, el_bins - 1)
    return az_i, el_i


class HrtfPannerKernel(_SpatialKernel):
    """The per-quantum FDL of one HRTF panner over N instances: states
    `xspec` (N, K-1, P+1) complex64, the last K-1 input spectra; `tail`
    (N, P), the last input quantum; `h_prev` (N, 2, K, P+1) complex64 and
    `g_prev` (N,), the previous quantum's HRIR spectra and gain; `started`
    (N,) bool, false until the first quantum, whose crossfade starts from
    the front direction at gain 0 (the crate's initial state)."""

    def __init__(self, node, rc):
        super().__init__(node)
        self.in_channels = max(1, rc.input_channel_counts[0])
        self.device = rc.device
        _, _, self.spectra_host, self.K = load_hrir_sphere(rc.sample_rate)
        self.vids_host, self.w_host, self.az_bins, self.el_bins = \
            bake_direction_grid(rc.sample_rate)

    def resources(self):
        # the front direction's spectra (grid centre), the first quantum's
        # crossfade origin: the weighted sum of complex64 spectra by real
        # weights, as the JAX kernel's complex einsum rounds it
        fv = self.vids_host[self.az_bins // 2, self.el_bins // 2]
        fw = self.w_host[self.az_bins // 2, self.el_bins // 2]
        front = (fw[0] * self.spectra_host[fv[0]]
                 + fw[1] * self.spectra_host[fv[1]]
                 + fw[2] * self.spectra_host[fv[2]]).astype(np.complex64)
        return {"spectra": self.spectra_host, "grid_vids": self.vids_host,
                "grid_w": self.w_host, "front": front}

    def tail_frames(self):
        return (self.K + 1) * PARTITION

    def init_state(self):
        P = PARTITION
        c64 = dict(dtype=torch.complex64, device=self.device)
        return {
            "xspec": torch.zeros((self.K - 1, P + 1), **c64),
            "tail": torch.zeros((P,), dtype=torch.float32, device=self.device),
            "h_prev": torch.zeros((2, self.K, P + 1), **c64),
            "g_prev": torch.zeros((), dtype=torch.float32, device=self.device),
            "started": torch.zeros((), dtype=torch.bool, device=self.device),
        }

    def quantum_directions(self, params, n: int, nq: int):
        """(azimuth, elevation, gain), each (n, nq) f32: the spatial
        pipeline on each quantum's first sample (k-rate HRTF,
        panner.rs:781-797)."""
        qparams = {k: v if v.dim() == 0 else v[..., ::PARTITION]
                   for k, v in params.items()}
        return [torch.broadcast_to(t, (n, 1, nq)).reshape(n, nq)
                for t in self.spatial_gains(qparams)]

    def process(self, scope, state, inputs, params):
        x = inputs[0]                                   # (N, C, B)
        n, B = scope.n, x.shape[-1]
        P, K = PARTITION, self.K
        nq = B // P
        res = scope.node_resources

        azimuth, elevation, gain = self.quantum_directions(params, n, nq)
        az_i, el_i = grid_cells(azimuth, elevation, self.az_bins, self.el_bins)
        vids = res["grid_vids"][0][az_i, el_i].to(torch.int64)   # (n, nq, 3)
        w = res["grid_w"][0][az_i, el_i]                         # (n, nq, 3)

        # the 3 vertex spectra of each quantum's cell, weighted: real and
        # imaginary parts apart, as a real matmul rounds them
        spectra = torch.view_as_real(res["spectra"][0])   # (V, 2, K, P+1, 2)
        wv = w[..., None, None, None, None]
        h = (wv[:, :, 0] * spectra[vids[..., 0]]
             + wv[:, :, 1] * spectra[vids[..., 1]]
             + wv[:, :, 2] * spectra[vids[..., 2]])
        h = torch.view_as_complex(h)                      # (n, nq, 2, K, P+1)

        # the previous quantum's HRIR and gain; the first quantum ever fades
        # from the front direction at gain 0 (panner.rs:226-241)
        started = state["started"]
        h_carry = torch.where(started[:, None, None, None], state["h_prev"],
                              res["front"][0])
        g_carry = torch.where(started, state["g_prev"], 0.0)
        g_prev = torch.cat([g_carry[:, None], gain[:, :-1]], dim=1)

        # mono downmix, x 2 gain correction for stereo (panner.rs:835-845)
        mono = x[:, 0] + x[:, 1] if self.in_channels >= 2 else x[:, 0]

        # per-quantum overlap-save: spectra of [previous quantum, quantum]
        ext = torch.cat([state["tail"], mono.expand(n, B)], dim=-1)
        X = torch.fft.rfft(ext.unfold(-1, 2 * P, P), dim=-1)  # (n, nq, P+1)
        xfull = torch.cat([state["xspec"], X], dim=1)     # (n, K-1+nq, P+1)

        # the K-partition window: quantum q's partition k meets the input
        # spectrum k quanta back; the previous HRIR is h shifted a quantum
        y_new = y_first = y_rest = 0
        for k in range(K):
            win = xfull[:, K - 1 - k:K - 1 - k + nq, None, :]   # (n, nq, 1, P+1)
            y_new = y_new + h[:, :, :, k] * win
            y_first = y_first + h_carry[:, None, :, k] * win[:, :1]
            y_rest = y_rest + h[:, :-1, :, k] * win[:, 1:]
        y_prev = torch.cat([y_first, y_rest], dim=1)
        yn = torch.fft.irfft(y_new, n=2 * P, dim=-1)[..., P:]  # (n, nq, 2, P)
        yp = torch.fft.irfft(y_prev, n=2 * P, dim=-1)[..., P:]

        # linear crossfade previous -> new across the quantum, and the
        # lerped distance gain (the hrtf crate)
        kfade = torch.arange(P, dtype=torch.float32, device=x.device) / P
        y = yp * (1.0 - kfade) + yn * kfade
        gmat = g_prev[..., None] + (gain - g_prev)[..., None] * kfade
        y = y * gmat[:, :, None, :]
        out = y.permute(0, 2, 1, 3).reshape(n, 2, B)

        new_state = {
            "xspec": xfull[:, xfull.shape[1] - (K - 1):].clone(),
            "tail": ext[:, B:].clone(),
            "h_prev": h[:, -1].clone(),
            "g_prev": gain[:, -1].clone(),
            "started": torch.ones_like(started),
        }
        return new_state, [out]
