// WaveShaper curve lookup on Hopper (sm_90a).
//
// Replaces the TPU kernel K1, webaudio_tpu/ops/curve_kernel.py::_kernel_v3
// (called through curve_lookup_tpu_v3), and its two study-mode siblings
// _kernel (curve_lookup_tpu) and _kernel_v2 (curve_lookup_tpu_v2).  All three
// compute the contract webaudio_tpu/nodes/waveshaper.py::_apply_curve_gather:
//
//     v = (n-1)/2 * (x+1), clipped to [0, n-1]
//     k = min(floor(v), n-2);  f = v - k
//     y = curve[k] * (1-f) + curve[k+1] * f
//
// The TPU kernels built a two-hot over 128-lane curve segments and
// contracted it on the matrix unit because gathers were slow there.  Hopper
// gathers from shared memory or L1 directly, so each thread computes one
// sample: it gathers curve[k] and curve[k+1] and takes the lerp.
//
// Bound: memory.  A sample costs 8 bytes of device traffic (x in, y out)
// plus the curve, which every block reads once: into shared memory when it
// fits in 48 KB (n <= 12288), otherwise through the read-only cache
// (__ldg).  The grid is capped at 8 resident blocks per SM and strides over
// the samples, so the curve is loaded at most 1056 times per launch, from
// L2 after the first block.
//
// A batch whose instances carry their own curves passes an (R, n) table and
// the row length: sample i reads row i / row_len, through the read-only
// cache, so one launch shapes every instance.
//
// Bit-exact against the plain PyTorch version
// (webaudio_tpu_torch/ops/curve_kernel.py::curve_lookup_reference): every
// operation is written with an explicit round-to-nearest intrinsic so that
// nvcc cannot contract the lerp into an FMA, and (n-1)/2 arrives as the f32
// the host computed.  A NaN sample reads index 0 and yields NaN (f = NaN).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;       // 132 SMs x 8 resident blocks
constexpr int kSharedMaxN = 12288;     // 48 KB of f32

struct Tap {
  int k;    // left curve index, in [0, n-2]
  float f;  // lerp weight of curve[k+1]
};

__device__ __forceinline__ Tap locate(float x, int n, float half_nm1,
                                      float n_m1) {
  float v = __fmul_rn(half_nm1, __fadd_rn(x, 1.0f));
  // NaN-propagating clip: comparisons with NaN are false, so NaN stays NaN
  v = v < 0.0f ? 0.0f : v;
  v = v > n_m1 ? n_m1 : v;
  const float fl = floorf(v);
  int k = (fl == fl) ? static_cast<int>(fl) : 0;
  k = k < n - 2 ? k : n - 2;
  return Tap{k, __fsub_rn(v, static_cast<float>(k))};
}

__device__ __forceinline__ float lerp(float f, float c0, float c1) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), c0), __fmul_rn(f, c1));
}

__global__ void curve_lookup_shared(const float* __restrict__ x,
                                    const float* __restrict__ curve,
                                    float* __restrict__ y, long long m,
                                    int n, float half_nm1) {
  extern __shared__ float s_curve[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_curve[i] = curve[i];
  __syncthreads();
  const float n_m1 = static_cast<float>(n - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += stride) {
    const Tap t = locate(__ldg(x + i), n, half_nm1, n_m1);
    y[i] = lerp(t.f, s_curve[t.k], s_curve[t.k + 1]);
  }
}

// kRows: curve is an (R, n) table and sample i reads row i / row_len
template <bool kRows>
__global__ void curve_lookup_global(const float* __restrict__ x,
                                    const float* __restrict__ curve,
                                    float* __restrict__ y, long long m,
                                    int n, float half_nm1, long long row_len) {
  const float n_m1 = static_cast<float>(n - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += stride) {
    const float* c = kRows ? curve + (i / row_len) * n : curve;
    const Tap t = locate(__ldg(x + i), n, half_nm1, n_m1);
    y[i] = lerp(t.f, __ldg(c + t.k), __ldg(c + t.k + 1));
  }
}

}  // namespace

// x, y: m contiguous f32 on the device; curve: n >= 2 contiguous f32, or
// with row_len > 0 an (m / row_len, n) table whose row r shapes samples
// [r * row_len, (r + 1) * row_len).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int curve_lookup_f32(const float* x, const float* curve, float* y,
                                long long m, int n, float half_nm1,
                                long long row_len, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_len > 0) {
    curve_lookup_global<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(x, curve, y, m, n, half_nm1, row_len);
  } else if (n <= kSharedMaxN) {
    const size_t smem = static_cast<size_t>(n) * sizeof(float);
    curve_lookup_shared<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        x, curve, y, m, n, half_nm1);
  } else {
    curve_lookup_global<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(x, curve, y, m, n, half_nm1, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
