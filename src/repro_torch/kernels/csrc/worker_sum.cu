// The ordered worker sum of the reference backend for Hopper (sm_90a): the
// sum over the leading worker axis of an (n, F) f32 stack, in the order in
// which JAX's run_reference reduces its vmapped messages
// (src/repro/core/efbv.py compress_round: jnp.mean over the worker axis,
// XLA's CPU reduce).
//
// Replaces no Pallas kernel: the JAX package's worker mean is XLA's.
//
// Column c of the output, one thread per column in a grid-stride loop:
//   acc = +0.0f;  for i in 0..n-1:  acc = acc + d[i, c]              (plain)
//                                   acc = fma(d[i, c], w_i, acc)     (weighted)
//   out[c] = acc,  or fused:  out[c] = fma(acc, cg, h[c]),
//                             out_h[c] = fma(acc, ch, h[c])
// The weight w_i is the participation mask m_i (w[i]), or the message's
// constant scale c for every row (d = y * c, rand-k's d/k, comp's k'/k:
// XLA's fused reduce contracts acc + y * c into one fma, fault u), or
// f32(m_i * c) (w[i]).  Over a fleet's stacked workers XLA unrolls the sum
// and drops its +0.0, and LLVM contracts the first pair the other way:
//   acc = fma(d[0, c], w_0, d[1, c] * w_1), then fma for i >= 2  (pair)
// A 0/1 mask times d is exact, so the fma gives the bits of m_i * d_i then
// the add, and keeps the product: 0 * NaN is NaN, as in JAX's mask * d.
//
// Windows (window = 32, XLA's CPU TreeReductionRewriter; fault v): a
// reduce over more than 32 rows is cut into windows of 32 rows after
// padding the rows with -n % 32 zeros, pad / 2 of them in front; each
// window sums its rows in order from +0.0, and the ceil(n / 32) partials
// are reduced the same way (windowed again while there are more than 32),
// the last level in order from +0.0.  The zeros change no bit: a sum that
// starts at +0.0 is never -0.0.  The rows stream through once: the first
// level's window in a register, the upper levels' open windows in a small
// stack.
//
// Every add is __fadd_rn and every fma __fmaf_rn, so nvcc contracts nothing
// the CPU does not; the fused form is what torch.add(h, sum, alpha=c)
// computes on either device, with the master update's folded constants
// f32(coef * 1/n) (core/efbv.py _mean_coef).
//
// A library reduction (torch.sum(dim=0), a cumsum) reorders the adds, so it
// is not bitwise; the plain loop costs n launches.
//
// Layout: consecutive threads read consecutive columns of one row, so every
// row's read is coalesced; the loop over the rows is unrolled by 8 so eight
// loads are in flight ahead of the serial adds.
//
// Plain C interface (loaded with ctypes, no PyTorch headers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// windowed levels above the first: 32**8 rows is beyond any n here
constexpr int kMaxLevels = 8;

// the weighting of the rows: none, w[i] per row, one scalar for all, or
// w[i] per row with the first pair unrolled
enum Weights { kPlain = 0, kRows = 1, kScalar = 2, kPair = 3 };

template <int kWeights>
__device__ __forceinline__ float term(float acc, const float* __restrict__ d,
                                      const float* __restrict__ w,
                                      float scale, long long i,
                                      long long cols, long long c) {
  const float v = d[i * cols + c];
  if (kWeights == kPlain) return __fadd_rn(acc, v);
  if (kWeights == kScalar) return __fmaf_rn(v, scale, acc);
  return __fmaf_rn(v, w[i], acc);
}

// rows [i0, i1) of column c added to acc in order
template <int kWeights>
__device__ __forceinline__ float in_order(float acc,
                                          const float* __restrict__ d,
                                          const float* __restrict__ w,
                                          float scale, long long i0,
                                          long long i1, long long cols,
                                          long long c) {
#pragma unroll 8
  for (long long i = i0; i < i1; ++i)
    acc = term<kWeights>(acc, d, w, scale, i, cols, c);
  return acc;
}

template <int kWeights, bool kFuse>
__global__ void __launch_bounds__(kThreads)
worker_sum_kernel(const float* __restrict__ d, const float* __restrict__ w,
                  float scale, int window, const float* __restrict__ h,
                  float* __restrict__ out, float* __restrict__ out_h,
                  long long n, long long cols, float cg, float ch) {
  // the windowed levels: items m[l] at level l (m[0] = n rows), the
  // front padding lo[l]; levels stop where at most `window` items remain
  long long m[kMaxLevels + 1], lo[kMaxLevels + 1];
  int levels = 0;
  if (window > 0) {
    long long items = n;
    while (items > window && levels < kMaxLevels) {
      m[levels] = items;
      lo[levels] = ((window - items % window) % window) / 2;
      items = (items + window - 1) / window;
      ++levels;
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < cols; c += stride) {
    float acc = 0.0f;
    if (levels == 0) {
      long long i0 = 0;
      if (kWeights == kPair) {
        acc = n > 1 ? __fmaf_rn(d[c], w[0], __fmul_rn(d[cols + c], w[1]))
                    : __fmul_rn(d[c], w[0]);
        i0 = n > 1 ? 2 : 1;
      }
      acc = in_order<kWeights>(acc, d, w, scale, i0, n, cols, c);
    } else {
      // open windows of the levels above the first: sum and items taken
      float part[kMaxLevels];
      long long taken[kMaxLevels];
      for (int l = 1; l < levels; ++l) {
        part[l] = 0.0f;
        taken[l] = 0;
      }
      for (long long s = -lo[0]; s < n; s += window) {
        const long long i0 = s < 0 ? 0 : s;
        const long long i1 = s + window < n ? s + window : n;
        float v = in_order<kWeights>(0.0f, d, w, scale, i0, i1, cols, c);
        // carry the finished window up through the levels it closes
        int l = 1;
        for (; l < levels; ++l) {
          part[l] = __fadd_rn(part[l], v);
          const long long pos = lo[l] + ++taken[l];
          if (pos % window != 0 && taken[l] != m[l]) break;
          v = part[l];
          part[l] = 0.0f;
        }
        if (l == levels) acc = __fadd_rn(acc, v);
      }
    }
    if (kFuse) {
      const float hv = h[c];
      out[c] = __fmaf_rn(acc, cg, hv);
      out_h[c] = __fmaf_rn(acc, ch, hv);
    } else {
      out[c] = acc;
    }
  }
}

template <int kWeights, bool kFuse>
void launch(const float* d, const float* w, float scale, int window,
            const float* h, float* out, float* out_h, long long n,
            long long cols, float cg, float ch, cudaStream_t stream) {
  long long blocks = (cols + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  worker_sum_kernel<kWeights, kFuse><<<(unsigned int)blocks, kThreads, 0,
                                       stream>>>(d, w, scale, window, h, out,
                                                 out_h, n, cols, cg, ch);
}

template <int kWeights>
void launch_fuse(const float* d, const float* w, float scale, int window,
                 const float* h, float* out, float* out_h, long long n,
                 long long cols, float cg, float ch, cudaStream_t stream) {
  if (h != nullptr)
    launch<kWeights, true>(d, w, scale, window, h, out, out_h, n, cols, cg,
                           ch, stream);
  else
    launch<kWeights, false>(d, w, scale, window, h, out, out_h, n, cols, cg,
                            ch, stream);
}

}  // namespace

// d: (n, cols) f32; weights: 0 plain, 1 the (n,) f32 w, 2 the scalar
// scale, 3 w with the first pair unrolled; window: 0 for rows in order at
// every n, 32 for XLA's windows (not with weights 3); h: (cols,) f32 or
// null (null: out = the sum; else out = fma(sum, cg, h) and out_h =
// fma(sum, ch, h)).
extern "C" int worker_sum_f32(const void* d, const void* w, float scale,
                              int weights, int window, const void* h,
                              void* out, void* out_h, long long n,
                              long long cols, float cg, float ch,
                              void* stream) {
  if (cols <= 0) return (int)cudaSuccess;
  if ((h != nullptr && out_h == nullptr) || weights < kPlain ||
      weights > kPair || ((weights == kRows || weights == kPair) &&
                          w == nullptr) ||
      window < 0 || (window > 0 && weights == kPair))
    return (int)cudaErrorInvalidValue;
  const float* dp = static_cast<const float*>(d);
  const float* wp = static_cast<const float*>(w);
  const float* hp = static_cast<const float*>(h);
  float* op = static_cast<float*>(out);
  float* ohp = static_cast<float*>(out_h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weights == kRows)
    launch_fuse<kRows>(dp, wp, scale, window, hp, op, ohp, n, cols, cg, ch,
                       s);
  else if (weights == kScalar)
    launch_fuse<kScalar>(dp, wp, scale, window, hp, op, ohp, n, cols, cg, ch,
                         s);
  else if (weights == kPair)
    launch_fuse<kPair>(dp, wp, scale, window, hp, op, ohp, n, cols, cg, ch,
                       s);
  else
    launch_fuse<kPlain>(dp, wp, scale, window, hp, op, ohp, n, cols, cg, ch,
                        s);
  return (int)cudaGetLastError();
}
