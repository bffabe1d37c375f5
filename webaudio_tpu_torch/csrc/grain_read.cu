// Grain reads on Hopper (sm_90a): the grouped two-tap lerp and the whole
// grain bank.
//
// grouped_lerp replaces three TPU kernels of webaudio_tpu/ops/grain_read.py
// that compute one contract, grouped_row_lerp (:832):
//   K3 _kernel_grouped_v  (called through grouped_row_lerp_v),
//   K4 _kernel            (called through windowed_read_tpu from
//                          windowed_lerp; window = group),
//   K7 _kernel_grouped_pl (called through grouped_row_lerp_pl).
// For each group of g samples along a row of pi:
//     w0  = min(pi[first], pi[last]);  loc = clip(pi - w0, 0, w - 2)
//     w0  = w0 mod wrap               (whole-buffer loops, pi unwrapped)
//     out[c] = ext[c, w0 + loc] * (1 - fr) + ext[c, w0 + loc + 1] * fr
// The TPU staged w-wide row copies of the buffer and selected lanes with a
// two-hot product, because gathers cost a descriptor each there.  Hopper
// gathers the two taps of every channel from the (C, L + W + 2) layout,
// which is a few MB and stays in L2.
// Bound: memory.  A sample moves pi (4 B) and fr (4 B) in and 4 C bytes
// out.  A first one-thread-per-sample kernel reached 41% of that: a
// capped grid-stride loop, two 64-bit divisions a sample and four
// dependent scalar loads before the gathers.  Design: a 2-D grid (x: tiles of 1,024 samples of a row, y:
// row, z: instance), so there is no grid-stride loop and no 64-bit
// division.
// Each thread owns 4 consecutive samples: one int4 load of pi, one float4
// load of fr, its 2 C x 4 tap gathers, one float4 store per channel.  A
// group's two ends come from warp shuffles: when g divides 128 a group
// never leaves its warp's 128 aligned samples (g = 12, say, would).  Any
// other g, a row length B that is not a multiple of 4, or a pointer off a
// 16-byte boundary takes the scalar path in the same kernel (32-bit index
// math, the group start by one 32-bit division a sample).
//
// grain_bank replaces K2, _kernel_grain_fused (called through
// _grain_bank_fused, :634): per sample and lane k, in the kernel body's f32
// steps (:562-592),
//     delta = base_f + rate * j      (j = sample within its 128-quantum)
//     idx   = base_i + floor(delta);  frac = delta - floor(delta)
//     piv   = clip(idx, 0, L - 1)
//     smp   = ext[c, piv] * (1 - frac) + ext[c, piv + 1] * frac
//             - edge[c] * (frac if piv + 1 >= L and (frac >= 1 - 1e-6 or
//                                                   piv == 0) else 0)
//     out[c] += (valid ? smp : 0) * clip(gain[k], gl0, gl1)
// with valid = ok and start <= t < stop and 0 <= idx <= L - 1, summed over
// k in ascending order.  The TPU walked k as the innermost grid axis and
// carried the output block from one grid step to the next; here one warp
// owns one (instance, quantum), 4 samples a thread, and sums the lanes in
// registers, so no reduction crosses blocks.  The TPU read
// each lane through a staged row starting at w0 = min of the clipped
// playhead at the group's two ends, with loc = clip(piv - w0, 0, w - 2).
// That clip never binds: w is ceil(g * rmax) + 3 and the f32 playhead is
// monotone within a quantum, so w0 + loc == piv for every sample, and this
// kernel reads ext[c, piv] directly
// (tests/test_torch_grain.py::test_grain_row_clip_never_binds).
// Bound: memory.  A sample moves the K gain rows (4 K bytes) and the output
// (4 C bytes); the lane fields are per quantum and the buffer lives in L2.
// What held a first one-thread-per-sample kernel at a quarter of that
// (16.5 us against 4.0 on an H100 at 400 grains, K 5) was latency: per
// thread, K serial chains of six field loads then the taps, in 2.6
// waves.  The design:
//   - one warp per (instance, quantum), blocks of kBankWarps quanta, 72
//     registers, so one wave holds 3,696 quanta (the 400-grain block has
//     3,446); thread `lane` owns samples lane + 32 s, s < 4;
//   - the lane fields once per (lane, quantum): the warp's first K
//     threads load them together (one round trip for up to 32 lanes),
//     classify the lane for the quantum (lane_plan: silent, inside, edge)
//     and hand that on with __shfl_sync; a silent lane reads nothing, an
//     inside lane runs without masks, clip or edge term, in 32-bit
//     indices; only a grain's first and last quanta and the buffer's ends
//     take the full per-sample rule;
//   - the gain rows of kBankChunk lanes are loaded before the first use;
//     each warp-wide load, like each store, is one 128-byte line;
//   - taps: sample-strided threads make each warp-wide gather cover ~35
//     neighbouring floats (1-2 lines).  Four consecutive samples a thread
//     (float4 gain loads) made each gather span 4x the lines and measured
//     slower; so did a persistent grid streaming the gain rows through a
//     shared-memory ring by bulk copy, and an L2 prefetch of the gain rows
//     (PERF.md);
//   - the lane sum starts at -0.0, the f32 sum's identity, so every lane
//     is one add and the sum equals the plain version's in ascending k;
//   - no division by a run-time value; gain and out need no alignment.
// Measured build (nvcc -Xptxas -v, sm_90a): grain_bank 72 registers (C 1
// and 2), grouped_lerp 30-40; no shared memory, no spills.
//
// Both kernels write every float step with an explicit round-to-nearest
// intrinsic, so nvcc cannot contract a product into an FMA, and they agree
// bit for bit with the plain PyTorch versions
// (webaudio_tpu_torch/ops/grain_read.py::grouped_lerp_reference,
// grain_bank_reference).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantum = 128;
constexpr int kLerpThreads = 256;             // 1,024 samples a block
constexpr int kBankWarps = 4;                 // quanta a block
constexpr int kBankChunk = 4;                 // lanes whose gain loads fly
constexpr int kBankMinBlocks = 7;             // 72 registers: one wave
                                              // holds 3,696 quanta
constexpr int kMaxGridYZ = 65535;
constexpr unsigned kFull = 0xffffffffu;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// w0 mod wrap as a floor modulo (torch.remainder), in 32 bits
__device__ __forceinline__ int wrap_start(int w0, int wrap) {
  if (wrap <= 0) return w0;
  const int m = w0 % wrap;
  return m < 0 ? m + wrap : m;
}

// the clipped first tap of a sample at p in a group that starts at w0
// (unwrapped) and w0w (wrapped)
__device__ __forceinline__ long long tap_index(int p, int w0, int w0w, int w,
                                               long long Lx) {
  long long loc = static_cast<long long>(p) - w0;
  loc = loc < 0 ? 0 : (loc > w - 2 ? w - 2 : loc);
  const long long idx = w0w + loc;
  return idx < 0 ? 0 : (idx > Lx - 2 ? Lx - 2 : idx);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// kC > 0: that many channels, unrolled; kC == 0: C at run time
template <int kC, bool kVec>
__global__ void __launch_bounds__(kLerpThreads) grouped_lerp_kernel(
    const float* __restrict__ ext, const int* __restrict__ pi,
    const float* __restrict__ fr, float* __restrict__ out, int i0,
    int ext_inst, int pi_inst, int C_rt, long long Lx, int R, int B, int g,
    int w, int wrap) {
  const int C = kC > 0 ? kC : C_rt;
  const int r = blockIdx.y;
  const long long i = static_cast<long long>(i0) + blockIdx.z;
  const long long row = (pi_inst ? i : 0) * R + r;
  const int* prow = pi + row * B;
  const float* frow = fr + row * B;
  const float* e = ext + (ext_inst ? i : 0) * C * Lx;
  const long long RB = static_cast<long long>(R) * B;
  float* orow = out + (i * C * R + r) * static_cast<long long>(B);
  const int b0 = (blockIdx.x * kLerpThreads + threadIdx.x) * 4;

  if (kVec) {
    // B % 4 == 0, g divides 128, pi, fr and out 16-byte aligned
    const bool in = b0 < B;
    int4 pv = make_int4(0, 0, 0, 0);
    float4 fv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) {                                // read once: evict first
      pv = __ldcs(reinterpret_cast<const int4*>(prow + b0));
      fv = __ldcs(reinterpret_cast<const float4*>(frow + b0));
    }
    const int p[4] = {pv.x, pv.y, pv.z, pv.w};
    const float f[4] = {fv.x, fv.y, fv.z, fv.w};
    long long idx[4];
    if (g >= 4) {
      // the group is g / 4 aligned lanes of this warp; every lane joins
      // the shuffles, also past the row's end
      const int lane = threadIdx.x & 31;
      const int first = lane & ~((g >> 2) - 1);
      const int pf = __shfl_sync(kFull, p[0], first);
      const int pl = __shfl_sync(kFull, p[3], first + (g >> 2) - 1);
      const int w0 = pf < pl ? pf : pl;
      const int w0w = wrap_start(w0, wrap);
#pragma unroll
      for (int s = 0; s < 4; ++s) idx[s] = tap_index(p[s], w0, w0w, w, Lx);
    } else {
      // g is 1, or 2: the pair {s, s ^ 1}
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int o = p[s ^ 1];
        const int w0 = g == 2 && o < p[s] ? o : p[s];
        idx[s] = tap_index(p[s], w0, wrap_start(w0, wrap), w, Lx);
      }
    }
    if (!in) return;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float ta[4], tb[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ta[s] = __ldg(e + c * Lx + idx[s]);
        tb[s] = __ldg(e + c * Lx + idx[s] + 1);
      }
      __stcs(reinterpret_cast<float4*>(orow + c * RB + b0),
             make_float4(lerp(ta[0], tb[0], f[0]), lerp(ta[1], tb[1], f[1]),
                         lerp(ta[2], tb[2], f[2]), lerp(ta[3], tb[3], f[3])));
    }
  } else {
    // any g dividing B, any B, any alignment: sample by sample
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int b = b0 + s;
      if (b >= B) break;
      const int first = static_cast<int>(static_cast<unsigned>(b) /
                                         static_cast<unsigned>(g)) * g;
      const int pf = __ldg(prow + first);
      const int pl = __ldg(prow + first + g - 1);
      const int w0 = pf < pl ? pf : pl;
      const long long idx =
          tap_index(__ldg(prow + b), w0, wrap_start(w0, wrap), w, Lx);
      const float f = __ldg(frow + b);
      for (int c = 0; c < C; ++c)
        orow[c * RB + b] = lerp(__ldg(e + c * Lx + idx),
                                __ldg(e + c * Lx + idx + 1), f);
    }
  }
}

// how a lane reads one quantum (lane_plan's mode)
constexpr int kSilent = 0;   // no sample sounds
constexpr int kInside = 1;   // every sample sounds, inside [0, L - 2]
constexpr int kEdge = 2;     // the grain's ends, the buffer's ends

// Once per (lane, quantum), by the thread that loaded the lane's fields:
// the frames [jlo, jhi) of the quantum that lie in [start, stop) and the
// read mode, packed as jlo | jhi << 8 | mode << 16.
__device__ __forceinline__ int lane_plan(float bf, float rt, int bi, int okk,
                                         int svk, int evk, long long tq,
                                         int L) {
  const long long lo = svk - tq, hi = evk - tq;
  if (okk == 0 || lo >= kQuantum || hi <= 0) return kSilent << 16;
  const int jlo = static_cast<int>(lo < 0 ? 0 : lo);
  const int jhi = static_cast<int>(hi > kQuantum ? kQuantum : hi);
  // the f32 playhead is monotone in j, so its ends bound every sample's
  const float f0 = floorf(__fadd_rn(bf, __fmul_rn(rt, 0.0f)));
  const float f1 = floorf(__fadd_rn(bf, __fmul_rn(rt, 127.0f)));
  const long long i0 = static_cast<long long>(bi) + static_cast<long long>(f0);
  const long long i1 = static_cast<long long>(bi) + static_cast<long long>(f1);
  const bool inside = jlo == 0 && jhi == kQuantum && fabsf(f0) < 1.0e9f &&
                      fabsf(f1) < 1.0e9f && (i0 < i1 ? i0 : i1) >= 0 &&
                      (i0 < i1 ? i1 : i0) <= L - 2;
  return jlo | jhi << 8 | (inside ? kInside : kEdge) << 16;
}

// one lane's contribution to a thread's 4 samples (j = lane + 32 s of the
// quantum), added to acc in the plain version's f32 steps
template <int C>
__device__ __forceinline__ void bank_lane(
    float (&acc)[C][4], const float (&gk)[4], const float* const (&ec)[C],
    const float (&edg)[C], const float (&ez)[C], int L, int lane, float bf,
    float rt, int bi, int plan, float gl0, float gl1, float edge_frac) {
  float env[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // NaN-propagating clip, as torch.clamp (two selects, no branch)
    const float hi = gk[s] > gl1 ? gl1 : gk[s];
    env[s] = gk[s] < gl0 ? gl0 : hi;
  }
  const int mode = plan >> 16;
  if (mode == kSilent) {
    // (valid ? smp : 0) * env with valid false: a signed zero, or NaN for
    // a NaN envelope
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float val = __fmul_rn(0.0f, env[s]);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c][s] = __fadd_rn(acc[c][s], val);
    }
    return;
  }
  if (mode == kInside) {
    // no masks, no clip, et = 0, and bi + floor(delta) fits 32 bits
    float ta[C][4], tb[C][4], fr[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float delta =
          __fadd_rn(bf, __fmul_rn(rt, static_cast<float>(lane + 32 * s)));
      const float dfl = floorf(delta);
      const int p = bi + static_cast<int>(dfl);
      fr[s] = __fsub_rn(delta, dfl);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        ta[c][s] = __ldg(ec[c] + p);
        tb[c][s] = __ldg(ec[c] + p + 1);
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c][s] = __fadd_rn(
            acc[c][s],
            __fmul_rn(__fsub_rn(lerp(ta[c][s], tb[c][s], fr[s]), ez[c]),
                      env[s]));
    return;
  }
  const int jlo = plan & 0xff, jhi = (plan >> 8) & 0xff;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = lane + 32 * s;
    const float delta = __fadd_rn(bf, __fmul_rn(rt, static_cast<float>(j)));
    const float dfl = floorf(delta);
    const long long idx =
        static_cast<long long>(bi) + static_cast<long long>(dfl);
    const int p = static_cast<int>(idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx));
    const float fs = __fsub_rn(delta, dfl);
    const bool valid = j >= jlo && j < jhi && idx >= 0 && idx <= L - 1;
    const float et = (p + 1 >= L && (fs >= edge_frac || p == 0)) ? fs : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float smp = __fsub_rn(
          lerp(__ldg(ec[c] + p), __ldg(ec[c] + p + 1), fs),
          __fmul_rn(edg[c], et));
      acc[c][s] = __fadd_rn(acc[c][s], __fmul_rn(valid ? smp : 0.0f, env[s]));
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kBankWarps * 32, kBankMinBlocks)
    grain_bank_kernel(const float* __restrict__ ext,
                      const float* __restrict__ edge,
                      const int* __restrict__ ok, const int* __restrict__ sv,
                      const int* __restrict__ ev,
                      const int* __restrict__ base_i,
                      const float* __restrict__ base_f,
                      const float* __restrict__ rate,
                      const float* __restrict__ gain, float* __restrict__ out,
                      int i0, int ext_inst, int field_inst, int gain_inst,
                      long long Lx, int L, int K, int nq,
                      const long long* __restrict__ frame0, float gl0,
                      float gl1, float edge_frac) {
  const int q = blockIdx.x * kBankWarps + (threadIdx.x >> 5);
  if (q >= nq) return;                       // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(i0) + blockIdx.y;
  const long long B = static_cast<long long>(nq) * kQuantum;
  // this thread's samples: lane + 32 s of quantum q
  const long long b0 = static_cast<long long>(q) * kQuantum + lane;
  // the block's first frame is device data (a captured walk replays this
  // launch for every block): read once a thread
  const long long tq = __ldg(frame0) + static_cast<long long>(q) * kQuantum;
  const float* grow = gain + (gain_inst ? i : 0) * K * B + b0;
  const long long ei = ext_inst ? i : 0;
  const float* ec[C];                        // each channel's buffer row
  float edg[C], ez[C], acc[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ec[c] = ext + (ei * C + c) * Lx;
    edg[c] = __ldg(edge + ei * C + c);
    ez[c] = __fmul_rn(edg[c], 0.0f);         // edge * et where et is 0
    // -0 is the f32 sum's identity (x + -0 == x, also for x = +-0), so
    // the sum over k starts there and equals the plain version's
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[c][s] = -0.0f;
  }
  const long long fbase = (field_inst ? i : 0) * K * nq + q;

  for (int k32 = 0; k32 < K; k32 += 32) {
    // lane k32 + lane's fields, one round trip for up to 32 lanes, and
    // its plan for this quantum
    float f_bf = 0.0f, f_rt = 0.0f;
    int f_bi = 0, f_plan = kSilent << 16;
    if (k32 + lane < K) {
      const long long fi = fbase + static_cast<long long>(k32 + lane) * nq;
      f_bf = __ldg(base_f + fi);
      f_rt = __ldg(rate + fi);
      f_bi = __ldg(base_i + fi);
      f_plan = lane_plan(f_bf, f_rt, f_bi, __ldg(ok + fi), __ldg(sv + fi),
                         __ldg(ev + fi), tq, L);
    }
    const int kn = K - k32 < 32 ? K - k32 : 32;
    for (int kc = 0; kc < kn; kc += kBankChunk) {
      // the chunk's gain rows, all in flight before the first use, read
      // once (evict first); each warp-wide load is one 128-byte line
      float gk[kBankChunk][4];
#pragma unroll
      for (int u = 0; u < kBankChunk; ++u)
        if (kc + u < kn) {
          const float* g = grow + static_cast<long long>(k32 + kc + u) * B;
#pragma unroll
          for (int s = 0; s < 4; ++s) gk[u][s] = __ldcs(g + 32 * s);
        }
#pragma unroll
      for (int u = 0; u < kBankChunk; ++u) {
        const int src = kc + u;
        if (src >= kn) continue;             // warp-uniform
        bank_lane<C>(acc, gk[u], ec, edg, ez, L, lane,
                     __shfl_sync(kFull, f_bf, src),
                     __shfl_sync(kFull, f_rt, src),
                     __shfl_sync(kFull, f_bi, src),
                     __shfl_sync(kFull, f_plan, src), gl0, gl1, edge_frac);
      }
    }
  }
  float* orow = out + i * C * B + b0;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < 4; ++s) __stcs(orow + c * B + 32 * s, acc[c][s]);
}

}  // namespace

// ext (Ie, C, Lx) f32; pi (Ip, R, B) int32; fr (Ip, R, B) f32; out
// (I, C, R, B) f32; Ie and Ip are 1 or I (flags ext_inst, pi_inst); g
// divides B and 1 <= g <= 128; B and wrap below 2^31, R at most 65,535.
// Launch on `stream` and return cudaGetLastError() (0 on success).
extern "C" int grouped_lerp_f32(const float* ext, const int* pi,
                                const float* fr, float* out, int I,
                                int ext_inst, int pi_inst, int C,
                                long long Lx, int R, long long B, int g,
                                int w, long long wrap, void* stream) {
  if (I <= 0 || R <= 0 || B <= 0 || C <= 0)
    return static_cast<int>(cudaGetLastError());
  if (B > INT32_MAX - 4 * kLerpThreads || wrap < 0 || wrap > INT32_MAX ||
      R > kMaxGridYZ || g < 1 || g > kQuantum || B % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = B % 4 == 0 && kQuantum % g == 0 && aligned16(pi) &&
                   aligned16(fr) && aligned16(out);
  const int Bi = static_cast<int>(B);
  const int wr = static_cast<int>(wrap);
  const unsigned tiles =
      static_cast<unsigned>((B + 4 * kLerpThreads - 1) / (4 * kLerpThreads));
  for (int i0 = 0; i0 < I; i0 += kMaxGridYZ) {
    const int n = I - i0 < kMaxGridYZ ? I - i0 : kMaxGridYZ;
    const dim3 grid(tiles, static_cast<unsigned>(R), static_cast<unsigned>(n));
    if (!vec)
      grouped_lerp_kernel<0, false><<<grid, kLerpThreads, 0, st>>>(
          ext, pi, fr, out, i0, ext_inst, pi_inst, C, Lx, R, Bi, g, w, wr);
    else if (C == 1)
      grouped_lerp_kernel<1, true><<<grid, kLerpThreads, 0, st>>>(
          ext, pi, fr, out, i0, ext_inst, pi_inst, C, Lx, R, Bi, g, w, wr);
    else if (C == 2)
      grouped_lerp_kernel<2, true><<<grid, kLerpThreads, 0, st>>>(
          ext, pi, fr, out, i0, ext_inst, pi_inst, C, Lx, R, Bi, g, w, wr);
    else
      grouped_lerp_kernel<0, true><<<grid, kLerpThreads, 0, st>>>(
          ext, pi, fr, out, i0, ext_inst, pi_inst, C, Lx, R, Bi, g, w, wr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ext (Ie, C, Lx) f32 with column L the end-of-buffer constant; edge
// (Ie, C); lane fields ok, sv, ev, base_i (If, K, nq) int32 and base_f,
// rate (If, K, nq) f32; gain (Ig, K, nq * 128) f32; out (I, C, nq * 128)
// f32; Ie, If and Ig are 1 or I.  C is 1 or 2; L below 2^31.  frame0
// points to the block's first frame, one int64 on the device.
extern "C" int grain_bank_launch(const float* ext, const float* edge,
                                 const int* ok, const int* sv, const int* ev,
                                 const int* base_i, const float* base_f,
                                 const float* rate, const float* gain,
                                 float* out, int I, int ext_inst,
                                 int field_inst, int gain_inst, int C,
                                 long long Lx, long long L, int K, int nq,
                                 const long long* frame0, float gl0,
                                 float gl1, float edge_frac, void* stream) {
  if (I <= 0 || nq <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if ((C != 1 && C != 2) || L < 1 || L >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Li = static_cast<int>(L);
  const unsigned blocks =
      static_cast<unsigned>((nq + kBankWarps - 1) / kBankWarps);
  for (int i0 = 0; i0 < I; i0 += kMaxGridYZ) {
    const int n = I - i0 < kMaxGridYZ ? I - i0 : kMaxGridYZ;
    const dim3 grid(blocks, static_cast<unsigned>(n));
#define GRAIN_BANK_LAUNCH(CC)                                             \
  grain_bank_kernel<CC><<<grid, kBankWarps * 32, 0, st>>>(                \
      ext, edge, ok, sv, ev, base_i, base_f, rate, gain, out, i0,         \
      ext_inst, field_inst, gain_inst, Lx, Li, K, nq, frame0, gl0, gl1,   \
      edge_frac)
    if (C == 1) GRAIN_BANK_LAUNCH(1);
    else GRAIN_BANK_LAUNCH(2);
#undef GRAIN_BANK_LAUNCH
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
