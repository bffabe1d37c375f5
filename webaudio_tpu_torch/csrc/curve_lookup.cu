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
// gathers directly: each sample reads curve[k] and curve[k+1] and takes the
// lerp.
//
// Bound: memory, 8 bytes a sample (x in, y out) plus the curve once: 1.3
// to 5 us at the render's shapes.  So fixed costs decide the time: the
// launch (the kernel launched on the plan's grid with no samples takes
// about half of the slice's time, in the same CUDA-graph replay), one
// round trip for x and one for the taps, and bringing the curve next to
// every SM, where one curve read by every SM at once crowds the few L2
// slices that hold it (the staged kernel runs the same samples faster
// through a table of 32 copies of the curve than through one).  PERF.md
// §6 has the measurements behind each choice below, from chip_smoke.py.
//
// One curve (curve_lookup_global): each thread gathers both taps through
// the read-only cache, one sample a step, 256-thread blocks, 8 a SM, one
// wave striding over the samples.  The render hands the kernel samples
// that are warm in L2 (the previous node just wrote them), and for those
// this beat staging: a block copying the curve into shared memory first
// waits for the whole copy from the crowded slices, where the read-only
// cache pulls only the lines the samples touch and neighbouring samples
// touch the same lines.
//
// An (R, n) table of per-instance curves (curve_lookup_rows; a
// MixedGraphBatch bucket whose members' curves differ): a 2-D grid,
// blockIdx.y the row, the blocks of a row striding over it, so no sample
// index is divided by the row length; x and y in 16-byte steps (4 samples
// a thread step, up to 4 steps in flight, streaming stores), scalars where
// x or y is off a 16-byte boundary.  Each row's curve lives in different
// lines, so staging pays here: with kStaged, thread 0 copies the row's
// curve into dynamic shared memory with one bulk copy (cp.async.bulk,
// completing on an mbarrier) while every thread has its first loads of x
// in flight, and threads wait on the barrier only before their first
// gather; a block that walks several rows refills its copy for each.  The
// host stages curves of up to 8,192 points (32 KB, inside the 48 KB a
// block has without opting in; 2 blocks of 512 a SM), and longer ones
// gather through the read-only cache (1 block of 1024).
//
// The host (ops/curve_kernel.py::launch_plan) picks the kernel, grid, block
// and shared-memory bytes; this file launches what it is given.
//
// Bit-exact against the plain PyTorch version
// (webaudio_tpu_torch/ops/curve_kernel.py::curve_lookup_reference): every
// operation is written with an explicit round-to-nearest intrinsic so that
// nvcc cannot contract the lerp into an FMA, and (n-1)/2 arrives as the f32
// the host computed.  A NaN sample reads index 0 and yields NaN (f = NaN).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSteps = 4;          // 16-byte loads of x a thread keeps in flight
constexpr int kBarBytes = 16;      // the mbarrier, ahead of the curve

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

// --- Hopper's copy engine and barriers (PTX) --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               "fence.proxy.async.shared::cta;\n"
               :: "r"(smem_addr(bar)), "r"(1u) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// The 16-byte-aligned span [src, src + bytes) around the n floats at p; the
// first of them lies `off` floats into it.  A bulk copy moves whole 16-byte
// units, so it may read up to 12 bytes on either side of the curve, inside
// the same 16-byte units of device memory, and never uses them.
struct Span {
  const char* src;
  unsigned bytes;
  int off;
};

__device__ __forceinline__ Span span_of(const float* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t{15};
  const uintptr_t hi =
      (a + 4 * static_cast<uintptr_t>(n) + 15) & ~uintptr_t{15};
  return Span{reinterpret_cast<const char*>(lo),
              static_cast<unsigned>(hi - lo), static_cast<int>((a - lo) >> 2)};
}

// Thread 0: expect the span's bytes on bar and start one bulk copy of it
// into s_curve (the copy engine moves it; no thread waits here).
__device__ __forceinline__ void fill(const Span& sp, float* s_curve,
                                     uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%2], [%3], %1, [%0];\n"
               :: "r"(smem_addr(bar)), "r"(sp.bytes), "r"(smem_addr(s_curve)),
                  "l"(sp.src) : "memory");
}

// ---------------------------------------------------------------------------

template <bool kStaged>
__device__ __forceinline__ float shape(const float* s, float x, int n,
                                       float half_nm1, float n_m1) {
  const Tap t = locate(x, n, half_nm1, n_m1);
  return kStaged ? lerp(t.f, s[t.k], s[t.k + 1])
                 : lerp(t.f, __ldg(s + t.k), __ldg(s + t.k + 1));
}

__device__ __forceinline__ void load_steps(float4 (&v)[kSteps],
                                           const float4* x4, long long n4,
                                           long long i, long long stride) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const long long j = i + u * stride;
    if (j < n4) v[u] = __ldcs(x4 + j);
  }
}

// One curve, m samples: each thread gathers both taps through the
// read-only cache, one sample a step, over a grid of 256-thread blocks that
// strides over the samples.  The render's samples arrive warm in L2 (the
// previous node wrote them), and for them this is the fastest of the
// designs measured: the taps of neighbouring samples fall on the same
// lines, which stay in L1 (PERF.md).
__global__ void curve_lookup_global(const float* __restrict__ x,
                                    const float* __restrict__ curve,
                                    float* __restrict__ y, long long m, int n,
                                    float half_nm1) {
  const float n_m1 = static_cast<float>(n - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += stride) {
    const Tap t = locate(__ldg(x + i), n, half_nm1, n_m1);
    y[i] = lerp(t.f, __ldg(curve + t.k), __ldg(curve + t.k + 1));
  }
}

// An (R, n) table, R rows of row_len samples, row r shaped through
// curve + r * n: the blocks of a row (gridDim.x) stride over it, the rows
// stride over gridDim.y, so no sample index is divided by the row length.
// kStaged: each block copies its row's curve into shared memory (one bulk
// copy by thread 0, on an mbarrier, while every thread's first 16-byte
// loads of x are in flight) and gathers there; otherwise it gathers
// through the read-only cache.  x and y move in 16-byte steps where they
// share their offset from a 16-byte boundary, as scalars elsewhere.
template <bool kStaged>
__global__ void __launch_bounds__(1024)
curve_lookup_rows(const float* __restrict__ x, const float* __restrict__ curve,
                  float* __restrict__ y, long long rows, long long row_len,
                  int n, float half_nm1) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_curve = reinterpret_cast<float*>(smem + kBarBytes);
  const float n_m1 = static_cast<float>(n - 1);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) ^
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  if (kStaged && threadIdx.x == 0) bar_init(bar);
  unsigned phase = 0;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const bool first = r == blockIdx.y;
    const float* xr = x + r * row_len;
    float* yr = y + r * row_len;
    const float* cr = curve + r * n;
    const Span sp = span_of(cr, n);
    if (kStaged && !first) __syncthreads();   // the previous row is read
    if (kStaged && threadIdx.x == 0) {
      if (!first) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fill(sp, s_curve, bar);
    }
    // the row's 16-byte body [head, head + 4 n4) and `rest` scalars around it
    long long head = row_len;
    if (vec) {
      head = ((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) >> 2;
      head = head < row_len ? head : row_len;
    }
    const long long n4 = (row_len - head) >> 2;
    const long long rest = row_len - 4 * n4;
    const float4* x4 = reinterpret_cast<const float4*>(xr + head);
    float4* y4 = reinterpret_cast<float4*>(yr + head);
    float4 v[kSteps];
    load_steps(v, x4, n4, gid, stride);       // in flight during the fill
    if (kStaged) {
      if (first) __syncthreads();             // the barrier is set up
      bar_wait(bar, phase);
      phase ^= 1u;
    }
    const float* c = kStaged ? s_curve + sp.off : cr;

    for (long long e = gid; e < rest; e += stride) {
      const long long i = e < head ? e : e + 4 * n4;
      yr[i] = shape<kStaged>(c, __ldg(xr + i), n, half_nm1, n_m1);
    }
    for (long long i = gid; i < n4;) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const long long j = i + u * stride;
        if (j < n4) {
          const float4 a = v[u];
          __stcs(y4 + j,
                 make_float4(shape<kStaged>(c, a.x, n, half_nm1, n_m1),
                             shape<kStaged>(c, a.y, n, half_nm1, n_m1),
                             shape<kStaged>(c, a.z, n, half_nm1, n_m1),
                             shape<kStaged>(c, a.w, n, half_nm1, n_m1)));
        }
      }
      i += kSteps * stride;
      load_steps(v, x4, n4, i, stride);
    }
  }
}

enum Kernel : int { kOneCurve = 0, kRowsStaged = 1, kRowsCached = 2 };

}  // namespace

// x, y: rows x row_len contiguous f32 on the device; curve: n >= 2
// contiguous f32 shaping all of x (kernel kOneCurve, rows = 1), or an
// (rows, n) table whose row r shapes row r of x (kRowsStaged, kRowsCached;
// these also take rows = 1).  kernel, grid, threads and smem_bytes come from the
// host's launch plan.  Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int curve_lookup_launch(const float* x, const float* curve,
                                   float* y, long long rows,
                                   long long row_len, int n, float half_nm1,
                                   int kernel, int grid_x, int grid_y,
                                   int threads, int smem_bytes, void* stream) {
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y), 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case kOneCurve:
      curve_lookup_global<<<grid, threads, 0, s>>>(x, curve, y,
                                                   rows * row_len, n,
                                                   half_nm1);
      break;
    case kRowsStaged:
      curve_lookup_rows<true><<<grid, threads, smem_bytes, s>>>(
          x, curve, y, rows, row_len, n, half_nm1);
      break;
    case kRowsCached:
      curve_lookup_rows<false><<<grid, threads, 0, s>>>(
          x, curve, y, rows, row_len, n, half_nm1);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `kernel` that the current device holds at once with `threads`
// threads and `smem_bytes` of dynamic shared memory.
extern "C" int curve_lookup_resident(int kernel, int threads, int smem_bytes,
                                     int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    const size_t bytes = static_cast<size_t>(smem_bytes);
    err = kernel == kOneCurve
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, curve_lookup_global, threads, 0)
          : kernel == kRowsStaged
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, curve_lookup_rows<true>, threads, bytes)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, curve_lookup_rows<false>, threads, 0);
  }
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// The current device's SM count and the shared memory a block has (without
// opting in to more).
extern "C" int curve_lookup_device(int* sms, int* smem_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_block, cudaDevAttrMaxSharedMemoryPerBlock,
                                 dev);
  return static_cast<int>(err);
}
