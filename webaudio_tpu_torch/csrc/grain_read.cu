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
// two-hot product, because gathers cost a descriptor each there.  Here one
// thread takes one (instance, row, sample): it reads pi at its own sample
// and at its group's two ends and gathers the two taps of every channel
// from the (C, L + W + 2) layout, which is a few MB and stays in L2.
// Bound: memory.  A sample moves pi (4 B) and fr (4 B) in and 4 C bytes
// out; the buffer is read from L2.
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
// carried the output block from one grid step to the next; here that is a
// loop inside the thread, with one f32 accumulator per channel, so no
// reduction crosses blocks.  The TPU read each lane through a staged row
// starting at w0 = min of the clipped playhead at the group's two ends, with
// loc = clip(piv - w0, 0, w - 2).  That clip never binds: w is
// ceil(g * rmax) + 3 and the f32 playhead is monotone within a quantum, so
// w0 + loc == piv for every sample, and this kernel reads ext[c, piv]
// directly (tests/test_torch_grain.py::test_grain_row_clip_never_binds).
// Bound: memory.  A sample moves the K gain rows (4 K bytes) and the output
// (4 C bytes); the lane fields are per quantum and the buffer lives in L2.
//
// Both kernels write every float step with an explicit round-to-nearest
// intrinsic, so nvcc cannot contract a product into an FMA, and they agree
// bit for bit with the plain PyTorch versions
// (webaudio_tpu_torch/ops/grain_read.py::grouped_lerp_reference,
// grain_bank_reference).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;
constexpr int kQuantum = 128;

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

__global__ void grouped_lerp_kernel(const float* __restrict__ ext,
                                    const int* __restrict__ pi,
                                    const float* __restrict__ fr,
                                    float* __restrict__ out, long long total,
                                    int ext_inst, int pi_inst, int C,
                                    long long Lx, int R, long long B, int g,
                                    int w, long long wrap) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < total; s += stride) {
    const long long b = s % B;
    const long long ir = s / B;
    const int r = static_cast<int>(ir % R);
    const long long i = ir / R;
    const long long row = (pi_inst ? i : 0) * R + r;
    const int* prow = pi + row * B;
    const long long first = (b / g) * g;
    const long long p_first = __ldg(prow + first);
    const long long p_last = __ldg(prow + first + g - 1);
    long long w0 = p_first < p_last ? p_first : p_last;
    long long loc = static_cast<long long>(__ldg(prow + b)) - w0;
    loc = loc < 0 ? 0 : (loc > w - 2 ? w - 2 : loc);
    if (wrap > 0) {
      w0 %= wrap;
      if (w0 < 0) w0 += wrap;
    }
    long long idx = w0 + loc;
    idx = idx < 0 ? 0 : (idx > Lx - 2 ? Lx - 2 : idx);
    const float f = __ldg(fr + row * B + b);
    const float omf = __fsub_rn(1.0f, f);
    const float* e = ext + (ext_inst ? i : 0) * C * Lx;
    for (int c = 0; c < C; ++c) {
      const float a = __ldg(e + c * Lx + idx);
      const float nb = __ldg(e + c * Lx + idx + 1);
      out[((i * C + c) * R + r) * B + b] =
          __fadd_rn(__fmul_rn(a, omf), __fmul_rn(nb, f));
    }
  }
}

template <int C>
__global__ void grain_bank_kernel(
    const float* __restrict__ ext, const float* __restrict__ edge,
    const int* __restrict__ ok, const int* __restrict__ sv,
    const int* __restrict__ ev, const int* __restrict__ base_i,
    const float* __restrict__ base_f, const float* __restrict__ rate,
    const float* __restrict__ gain, float* __restrict__ out, long long total,
    int ext_inst, int field_inst, int gain_inst, long long Lx, long long L,
    int K, int nq, long long frame0, float gl0, float gl1, float edge_frac) {
  const long long B = static_cast<long long>(nq) * kQuantum;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < total; s += stride) {
    const long long b = s % B;
    const long long i = s / B;
    const long long q = b / kQuantum;
    const float j = static_cast<float>(b % kQuantum);
    const long long t = frame0 + b;
    const long long ei = ext_inst ? i : 0;
    const float* e = ext + ei * C * Lx;
    float edg[C];
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      edg[c] = __ldg(edge + ei * C + c);
      acc[c] = 0.0f;
    }
    const long long fbase = (field_inst ? i : 0) * K * nq + q;
    const float* grow = gain + (gain_inst ? i : 0) * K * B + b;
    for (int k = 0; k < K; ++k) {
      const long long fi = fbase + static_cast<long long>(k) * nq;
      const float delta =
          __fadd_rn(__ldg(base_f + fi), __fmul_rn(__ldg(rate + fi), j));
      const float dfl = floorf(delta);
      const long long idx = static_cast<long long>(__ldg(base_i + fi)) +
                            static_cast<long long>(dfl);
      const float frac = __fsub_rn(delta, dfl);
      const long long piv = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
      const bool valid = __ldg(ok + fi) != 0 && t >= __ldg(sv + fi) &&
                         t < __ldg(ev + fi) && idx >= 0 && idx <= L - 1;
      const float gk = __ldg(grow + static_cast<long long>(k) * B);
      // NaN-propagating clip, as torch.clamp
      const float env = gk < gl0 ? gl0 : (gk > gl1 ? gl1 : gk);
      const float et =
          (piv + 1 >= L && (frac >= edge_frac || piv == 0)) ? frac : 0.0f;
      const float omf = __fsub_rn(1.0f, frac);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float a = __ldg(e + c * Lx + piv);
        const float nb = __ldg(e + c * Lx + piv + 1);
        float smp = __fadd_rn(__fmul_rn(a, omf), __fmul_rn(nb, frac));
        smp = __fsub_rn(smp, __fmul_rn(edg[c], et));
        const float v = __fmul_rn(valid ? smp : 0.0f, env);
        acc[c] = k == 0 ? v : __fadd_rn(acc[c], v);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) out[(i * C + c) * B + b] = acc[c];
  }
}

}  // namespace

// ext (Ie, C, Lx) f32; pi (Ip, R, B) int32; fr (Ip, R, B) f32; out
// (I, C, R, B) f32; Ie and Ip are 1 or I (flags ext_inst, pi_inst).  Launch
// on `stream` and return cudaGetLastError() (0 on success).
extern "C" int grouped_lerp_f32(const float* ext, const int* pi,
                                const float* fr, float* out, int I,
                                int ext_inst, int pi_inst, int C,
                                long long Lx, int R, long long B, int g,
                                int w, long long wrap, void* stream) {
  const long long total = static_cast<long long>(I) * R * B;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  grouped_lerp_kernel<<<grid_for(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ext, pi, fr, out, total, ext_inst, pi_inst, C, Lx, R, B, g, w, wrap);
  return static_cast<int>(cudaGetLastError());
}

// ext (Ie, C, Lx) f32 with column L the end-of-buffer constant; edge
// (Ie, C); lane fields ok, sv, ev, base_i (If, K, nq) int32 and base_f,
// rate (If, K, nq) f32; gain (Ig, K, nq * 128) f32; out (I, C, nq * 128)
// f32; Ie, If and Ig are 1 or I.  C is 1 or 2.
extern "C" int grain_bank_f32(const float* ext, const float* edge,
                              const int* ok, const int* sv, const int* ev,
                              const int* base_i, const float* base_f,
                              const float* rate, const float* gain,
                              float* out, int I, int ext_inst,
                              int field_inst, int gain_inst, int C,
                              long long Lx, long long L, int K, int nq,
                              long long frame0, float gl0, float gl1,
                              float edge_frac, void* stream) {
  const long long total = static_cast<long long>(I) * nq * kQuantum;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    grain_bank_kernel<1><<<grid_for(total), kThreads, 0, st>>>(
        ext, edge, ok, sv, ev, base_i, base_f, rate, gain, out, total,
        ext_inst, field_inst, gain_inst, Lx, L, K, nq, frame0, gl0, gl1,
        edge_frac);
  } else if (C == 2) {
    grain_bank_kernel<2><<<grid_for(total), kThreads, 0, st>>>(
        ext, edge, ok, sv, ev, base_i, base_f, rate, gain, out, total,
        ext_inst, field_inst, gain_inst, Lx, L, K, nq, frame0, gl0, gl1,
        edge_frac);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
