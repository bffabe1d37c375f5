// The buffer source's automated-rate playhead on Hopper (sm_90a): one
// launch computes a whole block of an AudioBufferSourceNode whose compound
// rate playback_rate * 2^(detune / 1200) is a dense row (an automated rate,
// a session's or an online context's forced rows, a batch's own rows).
//
// It replaces no TPU kernel.  The JAX package computes this block in XLA
// (webaudio_tpu/nodes/buffer_source.py::_process_cumsum); the port's tensor
// version of it, nodes/buffer_source.py::_BufferSourceKernel._process_cumsum,
// is ~155 separate device operations a block (the f32 within-quantum scans
// of ops/oscillator.py::cumsum_f32 alone are 62 adds each time), each a
// launch of a few microseconds on a few MB.  This kernel is that function,
// one CTA an instance, and the plain version is its contract on every
// device.  For frame n of the block, t = frame0 + n, in the plain version's
// order:
//     rate[n]   = f64(playback_rate[n]) * exp2(f64(detune[n]) / 1200)
//     sched[n]  = start_i <= t < stop_i
//     the start (t == start_frame in this block): offset_eff, its loop
//               clamps, pos0 = offset_eff * buf_rate, elapsed0 +=
//               |delta * rate| * fs
//     elapsed[n] = elapsed0 + excl_cumsum(sched ? |rate| : 0)[n]
//     active[n]  = sched[n] && elapsed[n] < duration * fs
//     pos[n]     = pos0 + excl_cumsum(active ? rate * ratio : 0)[n]
//     entered[n] = entered0 || any(active && (pos >= ls, or pos < le when
//                  the offset starts past the loop's end))[0..n]
//     pos_eff    = entered ? loop_wrap(pos) : pos   (1.5e-8 * max(|le|, 1)
//                  snap to ls), then the pair read and the f32 lerp, 0
//                  where not active or off the buffer
// where excl_cumsum is `_masked_cumsum_f64`: within each 128-frame quantum
// an f32 sum in cumsum_f32's order (sequential within each run of 16, a
// sequential prefix over the quantum's 8 run sums, each run's exclusive
// prefix added to its elements, the element itself taken off), and f64
// across quanta (an inclusive prefix over the quanta's f64 sums, each
// quantum's own sum taken off).  Every product and sum that the plain
// version rounds by itself is an intrinsic here (__fadd_rn, __dmul_rn,
// ...), so nvcc contracts nothing into an FMA.  Two f64 orders differ:
// each quantum's sum (torch reduces in an order of its own, another on
// the CPU than on the card; here sequential within a run, then over the
// runs) and the prefix over the quanta (torch's CPU scan is sequential;
// here a warp's shuffle scan over a pass's 32 quanta, after the earlier
// passes' sum).  The results differ from the plain version's by those f64
// roundings (~1e-16 relative), and two launches on the same input agree
// bit for bit (no atomics).
//
// Layout: one CTA of 256 threads an instance, a pass 4,096 frames.  A
// thread takes one run of 16 frames (8 threads a quantum) through the two
// scans (|rate|, then the playhead), each a warp-shuffle prefix over a
// quantum's runs, the quanta's sums through shared memory, and warp 0's
// scan over them; the loop's entry is a block-wide min of the first
// entering frame.  The reads go through shared memory: each thread leaves
// its frames' row index and lerp weight there, and the CTA then reads the
// pair rows and writes the output frame by frame across the threads, so a
// warp touches neighbouring rows and writes one contiguous run (a thread
// reading its own 16 frames would touch 32 rows 256 bytes apart a load,
// and the L1's wavefronts, not bytes, would set the pace).  Longer blocks
// take more passes, carrying the quanta's f64 prefix and the entered flag;
// thread 0 writes the carried state.  256 threads leave a thread 255
// registers: the run's 16 rates and 16 sums stay in them (at 512 threads
// and 128 registers they spilled).  A detune held over a run takes one
// exp2 (the exp2 is the largest part of the f64 work).
//
// Bound: latency.  A block of config 3's session (1 instance, 2 channels,
// 8,192 frames) reads 64 KB of rates and 128 KB of rows and writes 64 KB
// of output: 0.08 us at 3.35 TB/s.  What is left is one CTA's dependent
// chain on one SM: the f64 rates and scans of 16 frames a thread, two
// passes of a dozen barriers.

#include <cuda_runtime.h>
#include <math.h>

// must match ops/playhead.py::Constants field for field
struct PlayheadConstants {
  double ratio;          // buffer samples a context frame at rate 1
  double fs;             // context sample rate
  double buf_rate;       // buffer sample rate
  double buf_duration;   // seconds
  double offset;         // start offset, seconds
  double delta;          // sub-sample start, seconds (0 if never started)
  double dur_fs;         // duration * fs (inf: no limit)
  double loop_start;     // seconds (the offset's loop clamps)
  double loop_end;
  double ls;             // loop_start * buf_rate
  double le;             // loop_end * buf_rate
  double loop_len;       // le - ls
  double tol;            // 1.5e-8 * max(|le|, 1)
  long long start_frame; // the start's frame (2^31 - 1: never)
  long long start_i;     // min(start_frame, 2^31 - 1)
  long long stop_i;      // min(stop_frame, 2^31 - 1)
  long long length;      // buffer frames L
  int loop;
  int cond_ge;           // entry test pos >= ls (else pos < le)
};

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                            // cumsum_f32's runs
constexpr int kQuantum = 128;                       // RENDER_QUANTUM_SIZE
constexpr int kRunsPerQuantum = kQuantum / kRun;    // 8
constexpr int kChunk = kThreads * kRun;             // frames a pass
constexpr int kQuantaPerChunk = kChunk / kQuantum;  // 32, a warp's
static_assert(kQuantaPerChunk == 32, "warp 0 scans a pass's quanta");
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                           // loads issued at once
// a pass's row indices and weights, one pad a 32 so that the threads'
// runs of 16 land in distinct banks
constexpr int kPadded = kChunk + kChunk / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;
// torch compares k (f32) with the Python float 1.0 - 1e-6 in f32
constexpr float kEdgeFrac = static_cast<float>(1.0 - 1e-6);

__device__ __forceinline__ double detune_factor(float d) {
  return exp2(__ddiv_rn(static_cast<double>(d), 1200.0));
}

__device__ __forceinline__ double compound_rate(float p, float d) {
  return __dmul_rn(static_cast<double>(p), detune_factor(d));
}

// a thread's 16 frames of a row from frame n0: four 16-byte loads where
// the row's frames lie side by side and aligned, one value for all where
// the frame stride is 0
__device__ __forceinline__ void load_run(const float* row, int cs,
                                         long long n0, float (&x)[kRun]) {
  const float* p = row + n0 * cs;
  if (cs == 1 && (reinterpret_cast<unsigned long long>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < kRun / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = q.x;
      x[4 * i + 1] = q.y;
      x[4 * i + 2] = q.z;
      x[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kRun; ++u) x[u] = __ldg(p + u * cs);
  }
}

// torch.clamp: NaN passes through
__device__ __forceinline__ double clamp_d(double x, double lo, double hi) {
  return isnan(x) ? x : fmin(fmax(x, lo), hi);
}

// fmod(x, y), exact as fmod is: a playhead kept inside its loop is
// within one loop length of it, where the result is x or x - y (exact by
// Sterbenz's lemma), and only the rest takes the library's loop
__device__ __forceinline__ double fmod_d(double x, double y) {
  if (y > 0.0 && x > -y && x < y) return x;
  if (y > 0.0 && x >= y && x < 2.0 * y) return __dsub_rn(x, y);
  return fmod(x, y);
}

// nodes/buffer_source.py::_floor_mod: x mod y with the divisor's sign
__device__ __forceinline__ double floor_mod(double x, double y) {
  const double r = fmod_d(x, y);
  return (r != 0.0 && ((r < 0.0) != (y < 0.0))) ? __dadd_rn(r, y) : r;
}

// nodes/buffer_source.py::_loop_wrap
__device__ __forceinline__ double loop_wrap(double pos,
                                            const PlayheadConstants& k) {
  const double w = __dadd_rn(k.ls, floor_mod(__dsub_rn(pos, k.ls),
                                             k.loop_len));
  return __dsub_rn(k.le, w) <= k.tol ? k.ls : w;
}

// One pass's masked exclusive cumsum, in place on this thread's run: v
// holds the masked f64 values, and leaves as qoffs[q] + the f32 exclusive
// within-quantum sum.  qs: the pass's quantum sums in shared memory; nq:
// the pass's whole quanta; incl, last, first: warp 0's running f64 prefix
// across passes, the last quantum's sum, and whether none was summed yet
// (thread 0's are read at the end).  Every thread of the CTA calls it.
__device__ __forceinline__ void masked_cumsum(double (&v)[kRun], double* qs,
                                              int nq, double& incl,
                                              double& last, bool& first) {
  const int lane = threadIdx.x & 31;
  const int j = lane % kRunsPerQuantum;            // run within the quantum
  const int base = lane - j;
  const int q = threadIdx.x / kRunsPerQuantum;     // quantum within the pass
  float s = 0.0f;
  double part = 0.0;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const float f = __double2float_rn(v[u]);
    s = u == 0 ? f : __fadd_rn(s, f);
    part = u == 0 ? v[u] : __dadd_rn(part, v[u]);
  }
  // the runs' exclusive f32 prefix, sequential in run order, and the
  // quantum's f64 sum, sequential over the runs
  float pre = 0.0f, ex = 0.0f;
  double qsum = 0.0;
#pragma unroll
  for (int r = 0; r < kRunsPerQuantum; ++r) {
    const float t = __shfl_sync(kFull, s, base + r);
    const double p = __shfl_sync(kFull, part, base + r);
    if (r == j) ex = pre;
    pre = r == 0 ? t : __fadd_rn(pre, t);
    qsum = r == 0 ? p : __dadd_rn(qsum, p);
  }
  if (j == 0 && q < nq) qs[q] = qsum;
  __syncthreads();
  if (threadIdx.x < 32) {
    // warp 0: an inclusive f64 scan of the pass's quanta (one a lane),
    // after the earlier passes' sum; each quantum's own sum taken off
    const int i = threadIdx.x;
    const double x = i < nq ? qs[i] : 0.0;
    double y = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(kFull, y, d);
      if (i >= d) y = __dadd_rn(y, t);
    }
    y = first ? y : __dadd_rn(incl, y);
    if (i < nq) qs[i] = __dsub_rn(y, x);     // cumsum(qsums) - qsums
    incl = __shfl_sync(kFull, y, nq - 1);
    last = __shfl_sync(kFull, x, nq - 1);
    first = false;
  }
  __syncthreads();
  // the run's sequential sums again (kept in no registers meanwhile)
  const double qoff = q < nq ? qs[q] : 0.0;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const float f = __double2float_rn(v[u]);
    s = u == 0 ? f : __fadd_rn(s, f);
    const float within = __fsub_rn(__fadd_rn(s, ex), f);
    v[u] = __dadd_rn(qoff, static_cast<double>(within));
  }
}

// Grid: one CTA an instance i (n of them).  pr, dt: rate rows, row i at
// pr + i * pr_rs (pr_rs 0: one row for all), frame n at n * pr_cs (pr_cs
// 0: one value for the block); rows (R, L, 2C), instance i's at
// rows + i * rows_rs (0: one buffer); edge (R, C) likewise; out (n, C, B);
// the state in and out (n,).  B a multiple of 128.
__global__ void __launch_bounds__(kThreads, 1)
buffer_playhead_block(const float* __restrict__ pr, long long pr_rs,
                      int pr_cs, const float* __restrict__ dt,
                      long long dt_rs, int dt_cs,
                      const double* __restrict__ bt_in,
                      const double* __restrict__ el_in,
                      const unsigned char* __restrict__ en_in,
                      const float* __restrict__ rows, long long rows_rs,
                      const float* __restrict__ edge, long long edge_rs,
                      int channels, long long B,
                      const __grid_constant__ PlayheadConstants k,
                      long long frame0_host,
                      const long long* __restrict__ frame0_dev,
                      float* __restrict__ out, double* __restrict__ bt_out,
                      double* __restrict__ el_out,
                      unsigned char* __restrict__ en_out) {
  __shared__ double qs_abs[kQuantaPerChunk];
  __shared__ double qs_pos[kQuantaPerChunk];
  __shared__ int first_hit[kWarps];
  __shared__ int prev_s[kPadded];     // a frame's row, -1 where it reads 0
  __shared__ float k_s[kPadded];      // its lerp weight
  const long long inst = blockIdx.x;
  const float* pr_row = pr + inst * pr_rs;
  const float* dt_row = dt + inst * dt_rs;
  const float* rows_i = rows + inst * rows_rs;
  const float* edge_i = edge + inst * edge_rs;
  float* out_i = out + inst * channels * B;
  const long long frame0 = frame0_dev != nullptr ? *frame0_dev : frame0_host;
  const long long L = k.length;
  const int C = channels;

  // the start: whether it lies in this block, and the block's first
  // playhead and elapsed time
  const long long rel = k.start_frame - frame0;
  const bool in_block = rel >= 0 && rel < B;
  const double rate_n0 =
      in_block ? compound_rate(pr_row[rel * pr_cs], dt_row[rel * dt_cs])
               : 0.0;
  const double dr0 = __dmul_rn(k.delta, rate_n0);
  double offset_eff = clamp_d(__dadd_rn(k.offset, dr0), 0.0, k.buf_duration);
  if (k.loop) {
    offset_eff = rate_n0 >= 0.0 ? fmin(offset_eff, k.loop_end)
                                : fmax(offset_eff, k.loop_start);
  }
  const double pos0 = in_block ? __dmul_rn(offset_eff, k.buf_rate)
                               : bt_in[inst];
  const double elapsed0 = __dadd_rn(
      el_in[inst], in_block ? __dmul_rn(fabs(dr0), k.fs) : 0.0);
  bool entered = en_in[inst] != 0;

  // warp 0's running prefixes across passes
  double incl_abs = 0.0, last_abs = 0.0, incl_pos = 0.0, last_pos = 0.0;
  bool first_abs = true, first_pos = true;

  for (long long c0 = 0; c0 < B; c0 += kChunk) {
    const int r0 = static_cast<int>(threadIdx.x) * kRun;   // the run
    const long long n0 = c0 + r0;
    const bool mine = n0 < B;                // B is a multiple of 128
    const long long left = B - c0;
    const int frames = static_cast<int>(left < kChunk ? left : kChunk);
    const int nq = frames / kQuantum;
    double rate[kRun], v[kRun];
    unsigned sched = 0, active = 0;
    {
      float p[kRun] = {}, d[kRun] = {};
      if (mine) {
        load_run(pr_row, pr_cs, n0, p);
        load_run(dt_row, dt_cs, n0, d);
      }
      // detune held over a run (often all of it) takes one exp2
      float d_last = 0.0f;
      double e_last = 1.0;
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (u == 0 || d[u] != d_last) {
          e_last = detune_factor(d[u]);
          d_last = d[u];
        }
        rate[u] = mine ? __dmul_rn(static_cast<double>(p[u]), e_last) : 0.0;
        const long long t = frame0 + n0 + u;
        const bool on = mine && t >= k.start_i && t < k.stop_i;
        sched |= static_cast<unsigned>(on) << u;
        v[u] = on ? fabs(rate[u]) : 0.0;
      }
    }
    masked_cumsum(v, qs_abs, nq, incl_abs, last_abs, first_abs);
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      const bool on = ((sched >> u) & 1u) &&
                      __dadd_rn(elapsed0, v[u]) < k.dur_fs;
      active |= static_cast<unsigned>(on) << u;
      v[u] = on ? __dmul_rn(rate[u], k.ratio) : 0.0;
    }
    masked_cumsum(v, qs_pos, nq, incl_pos, last_pos, first_pos);
#pragma unroll
    for (int u = 0; u < kRun; ++u) v[u] = __dadd_rn(pos0, v[u]);

    // the sticky entered flag: set from the pass's first active frame
    // that meets the entry test on
    int from = kNone;
    if (k.loop) {
      int mine_first = kNone;
#pragma unroll
      for (int u = kRun - 1; u >= 0; --u) {
        const bool hit = ((active >> u) & 1u) &&
                         (k.cond_ge ? v[u] >= k.ls : v[u] < k.le);
        if (hit) mine_first = r0 + u;
      }
      const int wmin = __reduce_min_sync(kFull, mine_first);
      if ((threadIdx.x & 31) == 0) first_hit[threadIdx.x >> 5] = wmin;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kWarps; ++i) from = min(from, first_hit[i]);
    }

    // each frame's row and weight (the plain version's clamp: a valid
    // playhead has 0 <= floor(p) <= L - 1) ...
    if (mine) {
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        double p = v[u];
        if (k.loop && (entered || r0 + u >= from)) p = loop_wrap(p, k);
        const bool valid = ((active >> u) & 1u) && p >= 0.0 &&
                           p < static_cast<double>(L);
        const double fl = floor(p);
        const int f = r0 + u;
        prev_s[f + f / 32] = valid ? static_cast<int>(fl) : -1;
        k_s[f + f / 32] = valid ? __double2float_rn(__dsub_rn(p, fl)) : 0.0f;
      }
    }
    __syncthreads();
    // ... then the reads and the lerps frame by frame across the threads,
    // kGroup frames a thread at once: their indices, then every load of a
    // channel, then the lerps
    for (int f0 = 0; f0 < frames; f0 += kThreads * kGroup) {
      int prev[kGroup];
      float kk[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int f = f0 + g * kThreads + static_cast<int>(threadIdx.x);
        prev[g] = f < frames ? prev_s[f + f / 32] : -1;
        kk[g] = f < frames ? k_s[f + f / 32] : 0.0f;
      }
      for (int c = 0; c < C; ++c) {
        float a[kGroup], b[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float* row = rows_i + static_cast<long long>(prev[g]) * 2 * C;
          a[g] = prev[g] >= 0 ? __ldg(row + c) : 0.0f;
          b[g] = prev[g] >= 0 && prev[g] + 1 < L ? __ldg(row + C + c) : 0.0f;
        }
        const float e = __ldg(edge_i + c);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int f = f0 + g * kThreads + static_cast<int>(threadIdx.x);
          if (f >= frames) continue;
          if (prev[g] + 1 >= L) {            // the end's neighbour
            b[g] = k.loop || !(kk[g] >= kEdgeFrac || prev[g] == 0) ? e : 0.0f;
          }
          out_i[c * B + c0 + f] =
              prev[g] < 0 ? 0.0f
                          : __fadd_rn(__fmul_rn(a[g], __fsub_rn(1.0f, kk[g])),
                                      __fmul_rn(b[g], kk[g]));
        }
      }
    }
    entered = entered || from != kNone;
  }

  if (threadIdx.x == 0) {
    const double total_abs = __dadd_rn(__dsub_rn(incl_abs, last_abs),
                                       last_abs);
    const double total_pos = __dadd_rn(__dsub_rn(incl_pos, last_pos),
                                       last_pos);
    double pos_end = __dadd_rn(pos0, total_pos);
    if (k.loop && entered) {
      pos_end = __dadd_rn(k.ls, floor_mod(__dsub_rn(pos_end, k.ls),
                                          k.loop_len));
    }
    bt_out[inst] = pos_end;
    el_out[inst] = __dadd_rn(elapsed0, total_abs);
    en_out[inst] = entered ? 1 : 0;
  }
}

}  // namespace

// pr, dt f32 rate rows (row stride pr_rs / dt_rs floats, 0 for one row;
// frame stride pr_cs / dt_cs, 0 for a constant); bt_in, el_in f64 and
// en_in bool (n,); rows (R, L, 2C) and edge (R, C) f32, instance strides
// rows_rs / edge_rs (0 for one buffer); out (n, C, B) f32; bt_out, el_out,
// en_out (n,).  frame0 on the host, or at frame0_dev (an int64 on the
// device read when the kernel runs: a captured walk's).  Needs B > 0 a
// multiple of 128, 1 <= C, 1 <= L < 2^31, n < 2^31.
extern "C" int buffer_playhead_launch(
    const float* pr, long long pr_rs, int pr_cs, const float* dt,
    long long dt_rs, int dt_cs, const double* bt_in, const double* el_in,
    const unsigned char* en_in, const float* rows, long long rows_rs,
    const float* edge, long long edge_rs, int channels, long long B,
    long long n, const PlayheadConstants* consts, long long frame0,
    const long long* frame0_dev, float* out, double* bt_out, double* el_out,
    unsigned char* en_out, void* stream) {
  if (consts == nullptr || B <= 0 || B % kQuantum != 0 || channels < 1 ||
      n < 1 || n > 0x7fffffffLL || consts->length < 1 ||
      consts->length > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  buffer_playhead_block<<<static_cast<unsigned>(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pr, pr_rs, pr_cs, dt, dt_rs, dt_cs, bt_in, el_in, en_in, rows, rows_rs,
      edge, edge_rs, channels, B, *consts, frame0, frame0_dev, out, bt_out,
      el_out, en_out);
  return static_cast<int>(cudaGetLastError());
}
