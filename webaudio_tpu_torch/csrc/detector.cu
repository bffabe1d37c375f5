// The DynamicsCompressor's branching level detector, sample by sample, on
// Hopper (sm_90a).
//
// Replaces the per-sample `lax.scan` of
// webaudio_tpu/nodes/dynamics_compressor.py::_detector_sequential, which had
// no Pallas kernel on the TPU:
//
//     tau  = x[i] > y[i-1] ? attack_tau : release_tau
//     y[i] = tau * y[i-1] + (1 - tau) * x[i]
//
// It serves WEBAUDIO_DETECTOR=seq and the fixed-point detectors' exact
// fallback for instances whose branch pattern did not settle.  The
// recurrence is truly sequential (the coefficient depends on y[i-1]), so
// one thread carries one instance's y in f32 across its B samples.
//
// Bound: latency.  One instance is one chain of dependent steps (compare,
// select, multiply, add: about four dependent f32 operations a sample), so
// B samples take at least B such steps however fast the memory is; bytes
// (x in, y out) bound it only when thousands of instances run at once.
// What the design does about it: the thread keeps the next kChunk samples
// of x (and of the taus, where they vary by sample) in flight in registers
// while it walks the current ones, so a sample's load latency never sits on
// the chain.  Every step is written with round-to-nearest intrinsics so
// that nvcc cannot contract it into an FMA: the plain PyTorch version
// (webaudio_tpu_torch/ops/detector.py::detector_reference) rounds each
// product and the sum apart, and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__device__ __forceinline__ void load_chunk(const float* __restrict__ row,
                                           long long i0, long long b,
                                           float* v) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    v[j] = (i0 + j < b) ? __ldg(row + i0 + j) : 0.0f;
  }
}

// y0: (n,); x, y: (n, b); at, rt: (n, b) when per_sample, else (n,).
template <bool kPerSample>
__global__ void detector_seq(const float* __restrict__ y0,
                             const float* __restrict__ x,
                             const float* __restrict__ at,
                             const float* __restrict__ rt,
                             float* __restrict__ y, long long n, long long b) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (row >= n) return;
  const float* xr = x + row * b;
  float* yr = y + row * b;
  const float* ar = kPerSample ? at + row * b : at + row;
  const float* rr = kPerSample ? rt + row * b : rt + row;
  const float a_row = kPerSample ? 0.0f : __ldg(ar);
  const float r_row = kPerSample ? 0.0f : __ldg(rr);

  float prev = __ldg(y0 + row);
  float xc[kChunk], ac[kChunk], rc[kChunk];
  float xn[kChunk], an[kChunk], rn[kChunk];
  load_chunk(xr, 0, b, xc);
  if (kPerSample) {
    load_chunk(ar, 0, b, ac);
    load_chunk(rr, 0, b, rc);
  }
  for (long long i0 = 0; i0 < b; i0 += kChunk) {
    // the next chunk's loads go out before this chunk's chain starts
    const long long next = i0 + kChunk;
    load_chunk(xr, next, b, xn);
    if (kPerSample) {
      load_chunk(ar, next, b, an);
      load_chunk(rr, next, b, rn);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float xi = xc[j];
      const float a = kPerSample ? ac[j] : a_row;
      const float r = kPerSample ? rc[j] : r_row;
      const float tau = xi > prev ? a : r;
      prev = __fadd_rn(__fmul_rn(tau, prev),
                       __fmul_rn(__fsub_rn(1.0f, tau), xi));
      if (i0 + j < b) yr[i0 + j] = prev;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      xc[j] = xn[j];
      if (kPerSample) {
        ac[j] = an[j];
        rc[j] = rn[j];
      }
    }
  }
}

}  // namespace

// y0 (n,), x and y (n, b) contiguous f32 on the device; at and rt (n, b)
// when per_sample is nonzero, else (n,).  Launch on `stream` and return
// cudaGetLastError() (0 on success).
extern "C" int detector_seq_launch(const float* y0, const float* x,
                                   const float* at, const float* rt, float* y,
                                   long long n, long long b, int per_sample,
                                   void* stream) {
  if (n <= 0 || b <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_sample) {
    detector_seq<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        y0, x, at, rt, y, n, b);
  } else {
    detector_seq<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        y0, x, at, rt, y, n, b);
  }
  return static_cast<int>(cudaGetLastError());
}
