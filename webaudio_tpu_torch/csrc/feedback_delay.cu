// The constant feedback-delay loop on Hopper (sm_90a): one launch walks a
// whole block of a DelayNode whose constant delay feeds back into itself
// through k GainNodes of constant gain, with at most one signal from
// outside the loop added at the delay's input.
//
// It replaces no TPU kernel.  The two-rate compiler steps such a loop at
// the delay-bounded inner block, m sub-steps a block
// (webaudio_tpu/graph/compiler.py:652, run_group's inner `lax.scan`; on
// the port graph/compiler.py::run_step, a Python loop of ~10 device
// operations a sub-step).  This kernel does the same arithmetic per frame in one launch
// (ops/feedback.py::feedback_delay_reference is its plain version).  For
// frame n of the block, t = frame0 + n, p = t - shift:
//     a, b = ring[p mod R], ring[(p + 1) mod R]
//     r    = a * wa + b * wb            (b * wb where p == -1, 0 where
//                                        p < -1: nothing written there yet)
//     y    = ((r * g1) * g2) ... * gk
//     ring[t mod R] = x[n] + y          (y where the loop has no x)
// every product and sum rounded to f32 apart (__fmul_rn, __fadd_rn, so
// nvcc contracts nothing into an FMA): bit-equal to the stepped walk.
//
// The recurrence: frame n reads frames n - shift and n - shift + 1, so the
// frames of a run of L = min(shift - 1, R - shift) consecutive frames read
// only earlier runs (and, with L <= R - shift, no slot the run writes).
// One CTA a (instance, channel) row walks the block run by run, a
// __syncthreads between runs; within a run each thread loads the taps and
// x of kUnroll frames before it stores any (the stores may alias the
// loads, so nvcc would not hoist them), which keeps kThreads * kUnroll
// loads in flight.  A tap at a frame before frame0 is ring_in's; from
// frame0 on it is ring_out's, written by an earlier run of this launch
// (visible to the CTA after the barrier).  The slots the block does not
// write are copied from ring_in, so ring_in is never written.
//
// Bound: bytes, and the latency of the ceil(B / L) runs.  A block moves x
// in, r and y out, the ring in and out once: for config 3's bounce (1
// instance, 2 channels, 442,368 frames, shift 13,672, R 61,440) 11.6 MB,
// 3.5 us at 3.35 TB/s, in 33 runs that each wait for the one before.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 8;          // frames a thread loads before it stores
constexpr int kMaxGains = 16;

struct Gains {
  float g[kMaxGains];
  int k;
};

__device__ __forceinline__ long long floor_mod(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// Grid: one CTA a row (instance, channel).  ring_in, ring_out (rows, R);
// x (rows, B), (channels, B) when x_shared, or null; r, y (rows, B), y
// null when k == 0 (y is r).  2 <= shift < R < 2^30.
__global__ void __launch_bounds__(kThreads)
feedback_delay_loop(const float* __restrict__ ring_in, float* ring_out,
                    const float* __restrict__ x, float* __restrict__ r_out,
                    float* __restrict__ y_out, int channels, int x_shared,
                    int R, long long B, int shift, float wa, float wb,
                    const __grid_constant__ Gains gains,
                    long long frame0_host,
                    const long long* __restrict__ frame0_dev) {
  const long long row = blockIdx.x;
  const float* in_row = ring_in + row * R;
  float* out_row = ring_out + row * R;
  const float* x_row =
      x == nullptr ? nullptr : x + (x_shared ? row % channels : row) * B;
  float* r_row = r_out + row * B;
  float* y_row = y_out == nullptr ? nullptr : y_out + row * B;
  const long long frame0 = frame0_dev != nullptr ? *frame0_dev : frame0_host;
  const int L = shift - 1 < R - shift ? shift - 1 : R - shift;
  const int w0 = static_cast<int>(floor_mod(frame0, R));   // frame0's slot

  // the slots the block leaves as they were (B < R)
  for (long long k = B + threadIdx.x; k < R; k += kThreads) {
    long long s = w0 + k;
    if (s >= R) s -= R;
    out_row[s] = __ldg(in_row + s);
  }

  for (long long n0 = 0; n0 < B; n0 += L) {
    const int len = B - n0 < L ? static_cast<int>(B - n0) : L;
    const int ws = static_cast<int>(floor_mod(frame0 + n0, R));  // writes
    const int rs = ws >= shift ? ws - shift : ws - shift + R;     // tap a
    for (int c = threadIdx.x; c < len; c += kThreads * kUnroll) {
      float a[kUnroll], b[kUnroll], xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int o = c + u * kThreads;
        a[u] = b[u] = xv[u] = 0.0f;
        if (o < len) {
          const long long n = n0 + o;
          const long long p = frame0 + n - shift;
          int sa = rs + o;
          if (sa >= R) sa -= R;
          const int sb = sa + 1 < R ? sa + 1 : 0;
          if (p >= 0) a[u] = n >= shift ? out_row[sa] : __ldg(in_row + sa);
          if (p >= -1) {
            b[u] = n + 1 >= shift ? out_row[sb] : __ldg(in_row + sb);
          }
          if (x_row != nullptr) xv[u] = __ldcs(x_row + n);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int o = c + u * kThreads;
        if (o < len) {
          const long long n = n0 + o;
          const long long p = frame0 + n - shift;
          const float bw = __fmul_rn(b[u], wb);
          const float r = p >= 0 ? __fadd_rn(__fmul_rn(a[u], wa), bw)
                                 : (p == -1 ? bw : 0.0f);
          float y = r;
          for (int g = 0; g < gains.k; ++g) y = __fmul_rn(y, gains.g[g]);
          __stcs(r_row + n, r);
          if (y_row != nullptr) __stcs(y_row + n, y);
          int s = ws + o;
          if (s >= R) s -= R;
          out_row[s] = x_row != nullptr ? __fadd_rn(xv[u], y) : y;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ring_in, ring_out (rows, R) f32; x (rows, B), (channels, B) when
// x_shared, or null; r (rows, B); y (rows, B), or null when k == 0;
// gains[k] on the host; frame0 on the host, or at frame0_dev (an int64 on
// the device, read when the kernel runs: a captured walk's).  Needs
// 2 <= shift < R < 2^30 and k <= 16.
extern "C" int feedback_delay_launch(const float* ring_in, float* ring_out,
                                     const float* x, float* r, float* y,
                                     long long rows, int channels,
                                     int x_shared, long long R, long long B,
                                     long long shift, float wa, float wb,
                                     const float* gains, int k,
                                     long long frame0,
                                     const long long* frame0_dev,
                                     void* stream) {
  if (k < 0 || k > kMaxGains || shift < 2 || shift >= R || R >= (1 << 30) ||
      channels < 1 || rows < 1 || rows > 0x7fffffffLL || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Gains g = {};
  for (int i = 0; i < k; ++i) g.g[i] = gains[i];
  g.k = k;
  feedback_delay_loop<<<static_cast<unsigned>(rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ring_in, ring_out, x, r, y, channels, x_shared, static_cast<int>(R), B,
      static_cast<int>(shift), wa, wb, g, frame0, frame0_dev);
  return static_cast<int>(cudaGetLastError());
}
