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
// over (N, B), one recurrence an instance.  It is the card's default
// detector (nodes/dynamics_compressor.py::detector_mode) and the fixed-point
// detectors' exact fallback.  The contract is
// webaudio_tpu_torch/ops/detector.py::detector_reference, bit for bit: each
// product and the sum are rounded apart (`__fmul_rn`, `__fadd_rn`,
// `__fsub_rn`, which nvcc cannot contract into an FMA).
//
// Bound: latency.  The coefficient depends on y[i-1], so one instance is one
// chain of B dependent steps whatever the memory does; bytes (x in, y out)
// bound it only when thousands of instances run at once.  The design:
//
// - The chain.  (1 - a) x[i] and (1 - r) x[i] do not depend on y, so they
//   are taken off the chain; each step computes both candidates
//   a y + (1-a) x and r y + (1-r) x from y[i-1] at once and selects one by
//   x[i] > y[i-1]: multiply, add, select, three dependent operations where
//   compare, select tau, multiply, add were four.  The roundings are the
//   same, so the result is too.  The select is a byte permute (`step`).
//   On the H100 one step takes ~15 cycles alone (~20 in the loop), ~8 of
//   them the multiply and the add.
// - Spread over the card.  A CTA carries R <= 32 instances (one chain
//   thread each, all in warp 0), R chosen from N so that ceil(N / R) CTAs
//   cover the SMs: one instance a CTA up to N = #SMs, 32 only when N runs
//   into the thousands.  Warp 1 loads, warp 2 stores.
// - Coalesced, deep staging.  Tiles of R rows x T samples of x (and of the
//   taus, where they vary by sample) stream into shared memory through a
//   ring of kStages slots: whole row segments by TMA bulk copies
//   (`cp.async.bulk`, completion counted in bytes on an mbarrier), so
//   (kStages - 1) x T samples of each row are in flight while the chain
//   walks one tile; the chain threads wait on one barrier a tile.  Rows lie
//   T + 4 floats apart (T a multiple of 32), so the chain threads' float4
//   reads of one column fall in distinct banks.  The chain writes y over x
//   in its slot; warp 2 copies each finished tile back to HBM by bulk
//   stores and frees the slot.
// - Alignment.  The bulk copies need 16-byte addresses and sizes: B % 4 ==
//   0 and x, y (and the per-sample taus) on 16-byte boundaries.  Any other
//   input takes the same kernel with 4-byte `cp.async` loads (their
//   completion tracked by the same barrier) and plain coalesced stores.
//
// The kernel allocates nothing: the wrapper (ops/detector.py) allocates y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;
constexpr int kPad = 4;             // floats a row beyond T: 16 B mod 128 B
constexpr int kMaxRows = 32;        // chains a CTA: the lanes of warp 0
constexpr int kMinTile = 32;
constexpr int kMaxTile = 4096;
constexpr int kMaxSmem = 200 * 1024;     // a CTA's ring, at most
constexpr int kSmemPerSm = 220 * 1024;   // shared by the CTAs of one SM
constexpr int kMaxCtasPerSm = 8;
constexpr int kThreads = 96;        // warp 0 chains, warp 1 loads, 2 stores

struct Plan {
  int rows;    // R: instances a CTA
  int tile;    // T: samples a tile, a multiple of 32
  int ctas;
  int smem;    // bytes of dynamic shared memory a CTA
};

Plan make_plan(long long n, long long b, int arrays, int sms) {
  Plan p;
  const long long per_sm = (n + sms - 1) / sms;
  p.rows = static_cast<int>(per_sm < 1 ? 1 : per_sm > kMaxRows ? kMaxRows
                                                                : per_sm);
  const long long ctas = (n + p.rows - 1) / p.rows;
  p.ctas = static_cast<int>(ctas > 0x7fffffffLL ? 0x7fffffffLL : ctas);
  long long resident = (ctas + sms - 1) / sms;
  if (resident > kMaxCtasPerSm) resident = kMaxCtasPerSm;
  long long budget = kSmemPerSm / resident;
  if (budget > kMaxSmem) budget = kMaxSmem;
  long long tile = budget / (4LL * kStages * arrays * p.rows) - kPad;
  tile = tile / 32 * 32;
  const long long need = (b + 31) / 32 * 32;   // no longer than B needs
  if (tile > need) tile = need;
  if (tile > kMaxTile) tile = kMaxTile;
  if (tile < kMinTile) tile = kMinTile;
  p.tile = static_cast<int>(tile);
  p.smem = static_cast<int>(4LL * kStages * arrays * p.rows * (tile + kPad));
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared, counted on `bar` in bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src) : "memory");
}

// One step: both candidates from y[i-1] at once, then the select.  The
// select is a byte permute (`prmt`) whose selector comes from the compare.
// Written as `?:`, ptxas predicates the second add on the compare instead,
// and a predicate feeding the FMA pipe is slower: 18.4 cycles a step alone
// on the H100 against 15.4 (8.1 for the multiply and the add without a
// select; chip_smoke.py phase v measures all three).
__device__ __forceinline__ float step(float xi, float a, float r, float ax,
                                      float rx, float& prev) {
  asm("{\n\t.reg .pred p;\n\t.reg .f32 ta, tr, ya, yr;\n\t"
      ".reg .b32 s;\n\t"
      "setp.gt.f32 p, %1, %0;\n\t"
      "mul.rn.f32 ta, %2, %0;\n\t"
      "mul.rn.f32 tr, %3, %0;\n\t"
      "add.rn.f32 ya, ta, %4;\n\t"
      "add.rn.f32 yr, tr, %5;\n\t"
      "selp.b32 s, 0x3210, 0x7654, p;\n\t"
      "prmt.b32 %0, ya, yr, s;\n\t}"
      : "+f"(prev)
      : "f"(xi), "f"(a), "f"(r), "f"(ax), "f"(rx));
  return prev;
}

// y0: (n,); x, y: (n, b); at, rt: (n, b) when kPerSample, else (n,).
// Shared memory: kStages slots of kArrays (x, then a and r) x rows x
// (tile + kPad) floats; barriers full (data landed), done (y written) and
// empty (y stored) a slot.
template <bool kPerSample, bool kBulk>
__global__ void __launch_bounds__(kThreads)
detector_tiles(const float* __restrict__ y0, const float* __restrict__ x,
               const float* __restrict__ at, const float* __restrict__ rt,
               float* __restrict__ y, long long n, long long b, int rows,
               int tile) {
  constexpr int kArrays = kPerSample ? 3 : 1;
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t bars[3 * kStages];
  const int stride = tile + kPad;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int valid = static_cast<int>(n - row0 < rows ? n - row0 : rows);
  const long long ntiles = (b + tile - 1) / tile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t full0 = smem_u32(bars);
  const uint32_t done0 = full0 + 8 * kStages;
  const uint32_t empty0 = done0 + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full0 + 8 * s, kBulk ? 1 : 32);
      bar_init(done0 + 8 * s, rows);
      bar_init(empty0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto slot = [&](int s, int a) {
    return ring + static_cast<long long>(s * kArrays + a) * rows * stride;
  };
  const float* srcs[3] = {x, at, rt};

  if (warp == 0) {
    // the chains: lane l carries instance row0 + l
    if (lane >= rows) return;
    const long long row = row0 + lane;
    const bool live = row < n;
    float prev = live ? __ldg(y0 + row) : 0.0f;
    const float a_row = (!kPerSample && live) ? __ldg(at + row) : 0.0f;
    const float r_row = (!kPerSample && live) ? __ldg(rt + row) : 0.0f;
    const float oma_row = __fsub_rn(1.0f, a_row);
    const float omr_row = __fsub_rn(1.0f, r_row);
    for (long long k = 0; k < ntiles; ++k) {
      const int s = static_cast<int>(k % kStages);
      bar_wait(full0 + 8 * s, static_cast<uint32_t>((k / kStages) & 1));
      const long long left = b - k * tile;
      const int cnt = static_cast<int>(left < tile ? left : tile);
      float* xs = slot(s, 0) + lane * stride;
      const float* as = slot(s, kPerSample ? 1 : 0) + lane * stride;
      const float* rs = slot(s, kPerSample ? 2 : 0) + lane * stride;
      float4 v = *reinterpret_cast<const float4*>(xs);
      float4 a4 = *reinterpret_cast<const float4*>(as);
      float4 r4 = *reinterpret_cast<const float4*>(rs);
#pragma unroll 4
      for (int j = 0; j < cnt; j += 4) {
        // the next float4s of the row, read before this one's steps so the
        // shared-memory latency stays off the chain (the row's pad covers
        // j + 4 == tile)
        const float4 vn = *reinterpret_cast<const float4*>(xs + j + 4);
        const float4 an =
            kPerSample ? *reinterpret_cast<const float4*>(as + j + 4) : a4;
        const float4 rn =
            kPerSample ? *reinterpret_cast<const float4*>(rs + j + 4) : r4;
        const float xv[4] = {v.x, v.y, v.z, v.w};
        float av[4], rv[4], ax[4], rx[4], out[4];
        if (kPerSample) {
          av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
          rv[0] = r4.x; rv[1] = r4.y; rv[2] = r4.z; rv[3] = r4.w;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ax[q] = __fmul_rn(__fsub_rn(1.0f, av[q]), xv[q]);
            rx[q] = __fmul_rn(__fsub_rn(1.0f, rv[q]), xv[q]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            av[q] = a_row;
            rv[q] = r_row;
            ax[q] = __fmul_rn(oma_row, xv[q]);
            rx[q] = __fmul_rn(omr_row, xv[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          out[q] = step(xv[q], av[q], rv[q], ax[q], rx[q], prev);
        }
        *reinterpret_cast<float4*>(xs + j) =
            make_float4(out[0], out[1], out[2], out[3]);
        v = vn;
        a4 = an;
        r4 = rn;
      }
      // the bulk store reads the slot through the async proxy
      if (kBulk) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive(done0 + 8 * s);
    }
  } else if (warp == 1) {
    // the loads: tile k into slot k % kStages once its last tile is stored
    if (kBulk && lane != 0) return;
    for (long long k = 0; k < ntiles; ++k) {
      const int s = static_cast<int>(k % kStages);
      bar_wait(empty0 + 8 * s, static_cast<uint32_t>(((k / kStages) & 1) ^ 1));
      const long long col = k * tile;
      const long long left = b - col;
      const int cnt = static_cast<int>(left < tile ? left : tile);
      if (kBulk) {
        const uint32_t bytes = static_cast<uint32_t>(cnt) * 4u;
        bar_arrive_tx(full0 + 8 * s, bytes * valid * kArrays);
        for (int a = 0; a < kArrays; ++a) {
          for (int r = 0; r < valid; ++r) {
            bulk_load(smem_u32(slot(s, a) + r * stride),
                      srcs[a] + (row0 + r) * b + col, bytes, full0 + 8 * s);
          }
        }
      } else {
        for (int a = 0; a < kArrays; ++a) {
          for (int r = 0; r < valid; ++r) {
            const float* src = srcs[a] + (row0 + r) * b + col;
            const uint32_t dst = smem_u32(slot(s, a) + r * stride);
            for (int c = lane; c < cnt; c += 32) cp_async4(dst + 4 * c, src + c);
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                     ::"r"(full0 + 8 * s) : "memory");
      }
    }
  } else {
    // the stores: tile k back to HBM once its chains have passed
    if (kBulk && lane != 0) return;
    for (long long k = 0; k < ntiles; ++k) {
      const int s = static_cast<int>(k % kStages);
      bar_wait(done0 + 8 * s, static_cast<uint32_t>((k / kStages) & 1));
      const long long col = k * tile;
      const long long left = b - col;
      const int cnt = static_cast<int>(left < tile ? left : tile);
      if (kBulk) {
        for (int r = 0; r < valid; ++r) {
          bulk_store(y + (row0 + r) * b + col,
                     smem_u32(slot(s, 0) + r * stride),
                     static_cast<uint32_t>(cnt) * 4u);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      } else {
        for (int r = 0; r < valid; ++r) {
          const float* ys = slot(s, 0) + r * stride;
          float* dst = y + (row0 + r) * b + col;
          for (int c = lane; c < cnt; c += 32) dst[c] = ys[c];
        }
        __syncwarp();
      }
      if (lane == 0) bar_arrive(empty0 + 8 * s);
    }
    if (kBulk) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

template <bool kPerSample, bool kBulk>
cudaError_t launch(const Plan& p, const float* y0, const float* x,
                   const float* at, const float* rt, float* y, long long n,
                   long long b, cudaStream_t s) {
  auto kernel = detector_tiles<kPerSample, kBulk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.ctas, kThreads, p.smem, s>>>(y0, x, at, rt, y, n, b, p.rows,
                                           p.tile);
  return cudaGetLastError();
}

cudaError_t plan_for(long long n, long long b, int per_sample, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  *p = make_plan(n, b, per_sample ? 3 : 1, sms > 0 ? sms : 1);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The launch plan for (n, b): out[0] instances a CTA, out[1] samples a
// tile, out[2] CTAs, out[3] bytes of shared memory a CTA.  Returns a
// cudaError_t (0 on success).
extern "C" int detector_seq_plan(long long n, long long b, int per_sample,
                                 int* out) {
  Plan p;
  const cudaError_t err = plan_for(n, b, per_sample, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.rows;
  out[1] = p.tile;
  out[2] = p.ctas;
  out[3] = p.smem;
  return 0;
}

// y0 (n,), x and y (n, b) contiguous f32 on the device; at and rt (n, b)
// when per_sample is nonzero, else (n,).  Launch on `stream` and return
// cudaGetLastError() (0 on success).
extern "C" int detector_seq_launch(const float* y0, const float* x,
                                   const float* at, const float* rt, float* y,
                                   long long n, long long b, int per_sample,
                                   void* stream) {
  if (n <= 0 || b <= 0) return static_cast<int>(cudaGetLastError());
  Plan p;
  cudaError_t err = plan_for(n, b, per_sample, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((n + p.rows - 1) / p.rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bulk = b % 4 == 0 && aligned16(x) && aligned16(y) &&
                    (!per_sample || (aligned16(at) && aligned16(rt)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_sample) {
    err = bulk ? launch<true, true>(p, y0, x, at, rt, y, n, b, s)
               : launch<true, false>(p, y0, x, at, rt, y, n, b, s);
  } else {
    err = bulk ? launch<false, true>(p, y0, x, at, rt, y, n, b, s)
               : launch<false, false>(p, y0, x, at, rt, y, n, b, s);
  }
  return static_cast<int>(err);
}
