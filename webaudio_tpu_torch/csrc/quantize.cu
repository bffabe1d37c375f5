// Dithered 16-bit and 8-bit u-law bounces on Hopper (sm_90a).
//
// Replaces the TPU kernels K5, webaudio_tpu/ops/dither.py::_dither_kernel
// (called through dither_to_i16_tpu), and K6, ::_ulaw_kernel (called through
// ulaw_to_u8_tpu):
//
//     K5  q = clip(floor(x * 32767 + u), -32768, 32767)            -> int16
//     K6  x = clip(x, -1, 1);  y = sign(x) * log1p(255 |x|) / ln 256
//         q = clip(floor((y * 0.5 + 0.5) * 255 + u), 0, 255)         -> uint8
//
// with u uniform in [0, 1) (1-LSB RPDF dither).  The TPU drew u from its
// on-core generator and wrote int32 codes because of its (8, 128) tiling;
// here u comes from Philox4x32-10 written into the kernel and the codes are
// stored at their own width.
//
// Random numbers: key (seed, 0), counter (g, g >> 32, 0, 0) for the group
// g = i / 4 of flat element i; element i takes output word i % 4, and
// u = (r >> 8) * 2^-24, exact in f32.  A launch over a slice of a larger
// tensor passes the flat index of its first element as `offset` (a
// multiple of 4), so a batch bounced shard by shard draws the same u as
// one bounce of the whole batch.  The stream depends on the element
// index and the seed only, not on the launch geometry, so the plain PyTorch
// versions (webaudio_tpu_torch/ops/dither.py::dither_i16_reference,
// ulaw_u8_reference) give the same codes.  Every float step is written with
// an explicit round-to-nearest intrinsic so that nvcc cannot contract
// x * 32767 + u (or the u-law's affine steps) into an FMA, which would move
// codes at floor boundaries.  A NaN sample is quantized as 0.0; +-inf clip.
//
// Bound: memory.  A sample costs 4 bytes in and 2 (K5) or 1 (K6) out; one
// Philox call (10 rounds of two 32-bit multiplies) serves 4 samples, about
// 15 integer operations a sample, well under the card's integer rate at
// 3.35 TB/s.  So each thread takes one group of 4 samples: one 16-byte
// float4 load (when the input is 16-byte aligned), one Philox call, one
// 8-byte (K5) or 4-byte (K6) store, in a grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

struct U4 {
  uint32_t w[4];
};

__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return U4{{c0, c1, c2, c3}};
}

__device__ __forceinline__ float uniform(uint32_t r) {
  return __fmul_rn(static_cast<float>(r >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ float zero_nan(float x) { return x == x ? x : 0.0f; }

struct DitherI16 {
  using Out = int16_t;
  __device__ __forceinline__ static Out code(float x, float u) {
    float q = floorf(__fadd_rn(__fmul_rn(zero_nan(x), 32767.0f), u));
    q = fminf(fmaxf(q, -32768.0f), 32767.0f);
    return static_cast<Out>(q);
  }
  __device__ __forceinline__ static void store4(Out* p, const Out* v) {
    short4 s;
    s.x = v[0];
    s.y = v[1];
    s.z = v[2];
    s.w = v[3];
    *reinterpret_cast<short4*>(p) = s;
  }
};

struct UlawU8 {
  using Out = uint8_t;
  __device__ __forceinline__ static Out code(float x, float u) {
    x = fminf(fmaxf(zero_nan(x), -1.0f), 1.0f);
    const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
    // y = (sign(x) * log1p(255 |x|)) * f32(1 / ln 256), in JAX's order;
    // 0x1.715476p-3f is that f32 exactly (0.1803368777...)
    const float y = __fmul_rn(
        __fmul_rn(sgn, log1pf(__fmul_rn(255.0f, fabsf(x)))),
        0x1.715476p-3f);
    const float scaled =
        __fmul_rn(__fadd_rn(__fmul_rn(y, 0.5f), 0.5f), 255.0f);
    float q = floorf(__fadd_rn(scaled, u));
    q = fminf(fmaxf(q, 0.0f), 255.0f);
    return static_cast<Out>(q);
  }
  __device__ __forceinline__ static void store4(Out* p, const Out* v) {
    uchar4 s;
    s.x = v[0];
    s.y = v[1];
    s.z = v[2];
    s.w = v[3];
    *reinterpret_cast<uchar4*>(p) = s;
  }
};

template <class Op>
__global__ void quantize(const float* __restrict__ x,
                         typename Op::Out* __restrict__ y, long long m,
                         long long g0, uint32_t seed, bool vec) {
  using Out = typename Op::Out;
  const long long groups = (m + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const long long c = g + g0;
    const U4 r = philox4x32_10(static_cast<uint32_t>(c),
                               static_cast<uint32_t>(c >> 32), 0u, 0u, seed,
                               0u);
    const long long i0 = 4 * g;
    if (vec && i0 + 4 <= m) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + i0));
      const Out c[4] = {Op::code(v.x, uniform(r.w[0])),
                        Op::code(v.y, uniform(r.w[1])),
                        Op::code(v.z, uniform(r.w[2])),
                        Op::code(v.w, uniform(r.w[3]))};
      Op::store4(y + i0, c);
    } else {
      for (int j = 0; j < 4 && i0 + j < m; ++j) {
        y[i0 + j] = Op::code(__ldg(x + i0 + j), uniform(r.w[j]));
      }
    }
  }
}

template <class Op>
int launch(const float* x, typename Op::Out* y, long long m,
           long long offset, uint32_t seed, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const long long groups = (m + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // float4 loads and 4-wide stores need aligned pointers; the wrapper
  // allocates y, so only a sliced x can be misaligned
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % (4 * sizeof(*y)) == 0);
  quantize<Op><<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, y, m, offset / 4,
                                                      seed, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: m contiguous f32 on the device; y: m contiguous int16 (K5) or uint8
// (K6); offset: the flat index of x[0] in the stream, a multiple of 4 (the
// wrapper checks).  Launch on `stream` and return cudaGetLastError() (0 on
// success).
extern "C" int dither_i16(const float* x, int16_t* y, long long m,
                          long long offset, uint32_t seed, void* stream) {
  return launch<DitherI16>(x, y, m, offset, seed, stream);
}

extern "C" int ulaw_u8(const float* x, uint8_t* y, long long m,
                       long long offset, uint32_t seed, void* stream) {
  return launch<UlawU8>(x, y, m, offset, seed, stream);
}
