// The ordered worker sum of the reference backend for Hopper (sm_90a): the
// sum over the leading worker axis of an (n, F) f32 stack, in the order in
// which JAX's run_reference reduces its vmapped messages
// (src/repro/core/efbv.py compress_round: jnp.mean over the worker axis,
// XLA's CPU reduce).
//
// Replaces no Pallas kernel: the JAX package's worker mean is XLA's.
//
// Column c of the output:
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
// starts at +0.0 is never -0.0.
//
// Three layouts, chosen by the caller's launch plan (kernels/ops.py
// worker_sum_plan), each one launch:
//  * narrow (a windowed reduce over few columns, the reference round's
//    (1000, 112)): a CTA takes a tile of `tile` columns; its threads take
//    the first level's (window, column) pairs, each summing its window's
//    rows with every load issued before the chain of adds, so the windows
//    run in parallel where a serial chain of n adds would not.  The
//    partials go to shared memory, the upper levels are reduced there in
//    the same order by the same threads, and the tile's first threads add
//    the last level and apply the fused master update.  Up to the row count
//    whose partials fit in the plan's shared memory.
//  * column: one thread per column, the rows in order (orders "unrolled",
//    "pair", and any n <= 32) or the windows streamed, the upper levels'
//    open windows in a small stack (a windowed reduce beyond the narrow
//    layout's rows).  Loads are issued 32 rows at a time ahead of the adds.
//  * wide (many columns, cols % 4 == 0, 16-byte aligned): the column form
//    with 4 columns a thread and 16-byte loads and stores, 8 rows of loads
//    ahead of the adds.
//
// Bound: the bytes (read d once, write the sum) for the wide shapes; at the
// reference round's (1000, 112) the launch and the chain's latency, not the
// 448 KB: the narrow layout's chains are 32 adds (window) + 32 (last
// level), not 1000.
//
// Every add is __fadd_rn and every fma __fmaf_rn, so nvcc contracts nothing
// the CPU does not; the fused form is what torch.add(h, sum, alpha=c)
// computes on either device, with the master update's folded constants
// f32(coef * 1/n) (core/efbv.py _mean_coef).
//
// A library reduction (torch.sum(dim=0), a cumsum) reorders the adds, so it
// is not bitwise; the plain loop costs n launches.
//
// Plain C interface (loaded with ctypes, no PyTorch headers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32;
// windowed levels above the first: 32**8 rows is beyond any n here
constexpr int kMaxLevels = 8;
// the narrow layout's most shared memory: a CTA's without asking for more
// (the plan switches to the column layout above it)
constexpr int kSmemMax = 48 * 1024;

// the weighting of the rows: none, w[i] per row, one scalar for all, or
// w[i] per row with the first pair unrolled
enum Weights { kPlain = 0, kRows = 1, kScalar = 2, kPair = 3 };
enum Layout { kColumn = 0, kNarrow = 1, kWide = 2 };

template <int kWeights>
__device__ __forceinline__ float step(float acc, float v, float wi,
                                      float scale) {
  if (kWeights == kPlain) return __fadd_rn(acc, v);
  if (kWeights == kScalar) return __fmaf_rn(v, scale, acc);
  return __fmaf_rn(v, wi, acc);
}

template <int kVec>
__device__ __forceinline__ void load(float (&v)[kVec], const float* p) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void store(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// rows [i0, i1) of columns c..c+kVec-1 added to acc in order, the loads of
// each chunk of 32 / kVec rows (and their weights) issued before its adds
template <int kWeights, int kVec>
__device__ __forceinline__ void in_order(float (&acc)[kVec],
                                         const float* __restrict__ d,
                                         const float* __restrict__ w,
                                         float scale, long long i0,
                                         long long i1, long long cols,
                                         long long c) {
  constexpr int kChunk = kWindow / kVec;
  for (long long i = i0; i < i1; i += kChunk) {
    float v[kChunk][kVec], wv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      wv[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[j][k] = 0.0f;
      if (i + j < i1) {
        load<kVec>(v[j], d + (i + j) * cols + c);
        if (kWeights == kRows || kWeights == kPair) wv[j] = w[i + j];
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (i + j < i1)
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          acc[k] = step<kWeights>(acc[k], v[j][k], wv[j], scale);
  }
}

// out (and out_h) of columns c..c+kVec-1 from their sums and h's values
template <bool kFuse, int kVec>
__device__ __forceinline__ void finish(const float (&acc)[kVec],
                                       const float (&hv)[kVec],
                                       float* __restrict__ out,
                                       float* __restrict__ out_h,
                                       long long c, float cg, float ch) {
  if (kFuse) {
    float g[kVec], a[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      g[k] = __fmaf_rn(acc[k], cg, hv[k]);
      a[k] = __fmaf_rn(acc[k], ch, hv[k]);
    }
    store<kVec>(out + c, g);
    store<kVec>(out_h + c, a);
  } else {
    store<kVec>(out + c, acc);
  }
}

// the windowed levels: items m[l] at level l (m[0] = n rows), the front
// padding lo[l]; levels stop where at most 32 items remain
__device__ __forceinline__ int window_levels(long long n, long long* m,
                                             long long* lo) {
  int levels = 0;
  long long items = n;
  while (items > kWindow && levels < kMaxLevels) {
    m[levels] = items;
    lo[levels] = ((kWindow - items % kWindow) % kWindow) / 2;
    items = (items + lo[levels] + kWindow - 1) / kWindow;
    ++levels;
  }
  return levels;
}

// column and wide layouts: kVec columns a thread, grid-stride
template <int kWeights, bool kFuse, int kVec>
__global__ void __launch_bounds__(256)
worker_sum_columns(const float* __restrict__ d, const float* __restrict__ w,
                   float scale, int window, const float* __restrict__ h,
                   float* __restrict__ out, float* __restrict__ out_h,
                   long long n, long long cols, float cg, float ch) {
  long long m[kMaxLevels + 1], lo[kMaxLevels + 1];
  const int levels = window > 0 ? window_levels(n, m, lo) : 0;
  const long long groups = cols / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long c = g * kVec;
    float acc[kVec], hv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = hv[k] = 0.0f;
    if (kFuse) load<kVec>(hv, h + c);
    if (levels == 0) {
      long long i0 = 0;
      if (kWeights == kPair) {
        float d0[kVec], d1[kVec];
        load<kVec>(d0, d + c);
        if (n > 1) load<kVec>(d1, d + cols + c);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          acc[k] = n > 1 ? __fmaf_rn(d0[k], w[0], __fmul_rn(d1[k], w[1]))
                         : __fmul_rn(d0[k], w[0]);
        i0 = n > 1 ? 2 : 1;
      }
      in_order<kWeights, kVec>(acc, d, w, scale, i0, n, cols, c);
    } else {
      // open windows of the levels above the first: sums and items taken
      float part[kMaxLevels][kVec];
      long long taken[kMaxLevels];
      for (int l = 1; l < levels; ++l) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) part[l][k] = 0.0f;
        taken[l] = 0;
      }
      for (long long s = -lo[0]; s < n; s += kWindow) {
        const long long i0 = s < 0 ? 0 : s;
        const long long i1 = s + kWindow < n ? s + kWindow : n;
        float v[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = 0.0f;
        in_order<kWeights, kVec>(v, d, w, scale, i0, i1, cols, c);
        // carry the finished window up through the levels it closes
        int l = 1;
        for (; l < levels; ++l) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) part[l][k] = __fadd_rn(part[l][k],
                                                                v[k]);
          const long long pos = lo[l] + ++taken[l];
          if (pos % kWindow != 0 && taken[l] != m[l]) break;
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            v[k] = part[l][k];
            part[l][k] = 0.0f;
          }
        }
        if (l == levels)
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
      }
    }
    finish<kFuse, kVec>(acc, hv, out, out_h, c, cg, ch);
  }
}

// items [i0, i1) of one column of a level's partials in shared memory
// (item i at p[i * tile]) added in order from +0.0, the loads issued first
__device__ __forceinline__ float smem_window(const float* p, long long i0,
                                             long long i1, int tile) {
  float v[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j)
    v[j] = i0 + j < i1 ? p[(i0 + j) * tile] : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kWindow; ++j)
    if (i0 + j < i1) acc = __fadd_rn(acc, v[j]);
  return acc;
}

// narrow layout: a CTA per tile of columns, its threads over the first
// level's windows (slot = threadIdx.x / tile), the partials of every level
// in shared memory (tile x (m[1] + m[2] + ...) floats)
template <int kWeights, bool kFuse>
__global__ void __launch_bounds__(256)
worker_sum_narrow(const float* __restrict__ d, const float* __restrict__ w,
                  float scale, const float* __restrict__ h,
                  float* __restrict__ out, float* __restrict__ out_h,
                  long long n, long long cols, float cg, float ch,
                  int tile) {
  extern __shared__ float parts[];
  const int lane = threadIdx.x % tile;
  const int slot = threadIdx.x / tile;
  const int slots = blockDim.x / tile;
  const long long c = (long long)blockIdx.x * tile + lane;
  const bool live = c < cols && slot < slots;
  // h of the tile's columns, read before the chains
  float hv[1] = {kFuse && live && slot == 0 ? h[c] : 0.0f};
  // level 0: the rows' windows, each summed with its weights
  long long items = n;
  long long lo = ((kWindow - items % kWindow) % kWindow) / 2;
  long long wins = (items + lo + kWindow - 1) / kWindow;
  float* cur = parts;
  if (live) {
    for (long long win = slot; win < wins; win += slots) {
      const long long s = win * kWindow - lo;
      float acc[1] = {0.0f};
      in_order<kWeights, 1>(acc, d, w, scale, s < 0 ? 0 : s,
                            s + kWindow < n ? s + kWindow : n, cols, c);
      cur[win * tile + lane] = acc[0];
    }
  }
  __syncthreads();
  // the upper levels, windowed again while more than 32 items remain
  items = wins;
  while (items > kWindow) {
    lo = ((kWindow - items % kWindow) % kWindow) / 2;
    wins = (items + lo + kWindow - 1) / kWindow;
    float* next = cur + items * tile;
    if (live) {
      for (long long win = slot; win < wins; win += slots) {
        const long long s = win * kWindow - lo;
        next[win * tile + lane] = smem_window(
            cur + lane, s < 0 ? 0 : s, s + kWindow < items ? s + kWindow
                                                           : items, tile);
      }
    }
    __syncthreads();
    cur = next;
    items = wins;
  }
  // the last level in order from +0.0, then the master update
  if (live && slot == 0) {
    float acc[1] = {smem_window(cur + lane, 0, items, tile)};
    finish<kFuse, 1>(acc, hv, out, out_h, c, cg, ch);
  }
}

// the narrow layout's shared memory: tile x the items above the first
// level
long long narrow_smem(long long n, int tile) {
  long long total = 0;
  long long items = n;
  while (items > kWindow) {
    const long long lo = ((kWindow - items % kWindow) % kWindow) / 2;
    items = (items + lo + kWindow - 1) / kWindow;
    total += items;
  }
  return 4 * total * tile;
}

struct Launch {
  const float* d;
  const float* w;
  float scale;
  int window;
  const float* h;
  float* out;
  float* out_h;
  long long n, cols;
  float cg, ch;
  int layout, tile, threads, smem;
  long long grid;
  cudaStream_t stream;
};

template <int kWeights, bool kFuse>
int launch(const Launch& a) {
  const dim3 grid((unsigned int)a.grid), block((unsigned int)a.threads);
  if (a.layout == kNarrow) {
    if constexpr (kWeights != kPair)
      worker_sum_narrow<kWeights, kFuse><<<grid, block, a.smem, a.stream>>>(
          a.d, a.w, a.scale, a.h, a.out, a.out_h, a.n, a.cols, a.cg, a.ch,
          a.tile);
  } else if (a.layout == kWide) {
    worker_sum_columns<kWeights, kFuse, 4><<<grid, block, 0, a.stream>>>(
        a.d, a.w, a.scale, a.window, a.h, a.out, a.out_h, a.n, a.cols, a.cg,
        a.ch);
  } else {
    worker_sum_columns<kWeights, kFuse, 1><<<grid, block, 0, a.stream>>>(
        a.d, a.w, a.scale, a.window, a.h, a.out, a.out_h, a.n, a.cols, a.cg,
        a.ch);
  }
  return (int)cudaGetLastError();
}

template <int kWeights>
int launch_fuse(const Launch& a) {
  return a.h != nullptr ? launch<kWeights, true>(a)
                        : launch<kWeights, false>(a);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// d: (n, cols) f32; weights: 0 plain, 1 the (n,) f32 w, 2 the scalar
// scale, 3 w with the first pair unrolled; window: 0 for rows in order at
// every n, 32 for XLA's windows (not with weights 3); h: (cols,) f32 or
// null (null: out = the sum; else out = fma(sum, cg, h) and out_h =
// fma(sum, ch, h)).  The launch plan (kernels/ops.py worker_sum_plan):
// layout 0 column, 1 narrow (window 32 and n > 32 only), 2 wide (cols % 4
// == 0, every pointer 16-byte aligned); tile: the narrow layout's columns
// a CTA; threads a CTA; grid CTAs; smem: the narrow layout's bytes.
extern "C" int worker_sum_f32(const void* d, const void* w, float scale,
                              int weights, int window, const void* h,
                              void* out, void* out_h, long long n,
                              long long cols, float cg, float ch, int layout,
                              int tile, int threads, long long grid,
                              int smem, void* stream) {
  if (cols <= 0) return (int)cudaSuccess;
  if ((h != nullptr && out_h == nullptr) || weights < kPlain ||
      weights > kPair || ((weights == kRows || weights == kPair) &&
                          w == nullptr) ||
      (window != 0 && window != kWindow) ||
      (window > 0 && weights == kPair) || n <= 0 || threads <= 0 ||
      threads > 256 || grid <= 0 || grid > 0x7fffffffLL || layout < kColumn ||
      layout > kWide)
    return (int)cudaErrorInvalidValue;
  if (layout == kNarrow &&
      (window != kWindow || n <= kWindow || tile <= 0 || threads % tile ||
       grid * tile < cols || smem > kSmemMax || smem < narrow_smem(n, tile)))
    return (int)cudaErrorInvalidValue;
  if (layout != kNarrow && smem != 0) return (int)cudaErrorInvalidValue;
  if (layout == kWide &&
      (cols % 4 || !aligned16(d) || !aligned16(out) ||
       (h != nullptr && (!aligned16(h) || !aligned16(out_h)))))
    return (int)cudaErrorMisalignedAddress;
  Launch a{static_cast<const float*>(d), static_cast<const float*>(w),
           scale, window, static_cast<const float*>(h),
           static_cast<float*>(out), static_cast<float*>(out_h), n, cols, cg,
           ch, layout, tile, threads, smem, grid,
           static_cast<cudaStream_t>(stream)};
  if (weights == kRows) return launch_fuse<kRows>(a);
  if (weights == kScalar) return launch_fuse<kScalar>(a);
  if (weights == kPair) {
    if (layout == kNarrow) return (int)cudaErrorInvalidValue;
    return launch_fuse<kPair>(a);
  }
  return launch_fuse<kPlain>(a);
}
