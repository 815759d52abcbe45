// Dense block-top-k and the fused dense EF-BV worker update, for Hopper
// (sm_90a), in f32 and bf16.
//
// Replaces: src/repro/kernels/block_topk.py::block_topk_pallas (body
// _block_topk_kernel) and ::efbv_update_pallas (body _efbv_update_kernel),
// both selecting with _select_mask.
//
// Per (nb, BLOCK) row, with keep the kb largest |.| of the row (ties to the
// lowest column; a row holding a NaN keeps nothing; block_select.cuh):
//   block_topk:   out = x * keep                       (in x's type)
//   efbv_update:  delta = f32(g) - f32(h)
//                 d     = T(delta * keep)
//                 h_out = T(f32(h) + lam * f32(d))     (T: g's and h's type)
// with "* keep" and "h + lam * d" rounded as below.
//
// Rounding matches the Pallas kernels in interpret mode (jitted by XLA on
// the CPU) bit for bit:
//   * "* keep" is a real multiply by 1.0 or 0.0 (__fmul_rn), so an
//     unselected -0.0 or negative value gives -0.0, an unselected NaN stays
//     NaN and an unselected inf gives NaN -- except where the product is
//     f32 at kb = 1 (block_topk of f32 x, and efbv_update's f32 delta):
//     there XLA folds the one-round mask into a select that writes +0.0 for
//     every unselected value (ROADMAP fault i); the kernels select there
//     too.  A bf16 block_topk multiplies at every kb;
//   * h_out = h + lam * d is one fused multiply-add (__fmaf_rn): XLA
//     contracts it -- except for f32 at kb = 1, where the select stands
//     between the multiply and the add and each rounds on its own
//     (__fmul_rn then __fadd_rn; nvcc would contract them otherwise).
//     On exactly one unreshaped (8, block) f32 tile at kb = 1 XLA
//     contracts there too (ROADMAP fault m): the wrapper passes fused = 1;
//   * bf16 values are read exactly into f32, and d and h_out are rounded
//     back to nearest even (__float2bfloat16, as torch rounds on the card).
//
// Selection (block_select.cuh): a threshold search replaced the kb rounds
// of warp-shuffle argmax that these kernels ran until then (192 thread
// instructions per value at BLOCK 256, kb 16; 432 at 1024/64): the kb-th
// largest key by bisection with an early exit, then every key above it and
// the lowest columns among the keys equal to it.  These kernels need only
// the mask, not the payload order.
//
// Layouts: one warp per row with the row in registers (BLOCK / 32 values
// per lane, coalesced 128-byte loads and stores of f32, 64-byte of bf16), 8
// rows per CTA, for every BLOCK % 128 == 0 up to 1024; one CTA per row for
// every block % 128 == 0 from 1152 to 4096, the block a run-time argument:
// PER = 16, 8 or 4 values a thread (the most that leaves whole warps:
// block % 512, % 256, % 128), block / PER threads, thread t holding
// columns t, t + block / PER, ...  Above 4096 (any block % 128 == 0, as
// the TPU kernels take) the row no longer fits in a CTA's registers: one
// CTA of 1024 threads per row (*_big) reads it again at each step of the
// search (block_select::select_cut), from shared memory where the row fits
// (staged once as f32: up to 57,856 values) and from device memory above
// (x, or g and h, read again); right, not fast: PERF.md has its times.
//
// Bound: memory.  block_topk reads x and writes out (8 B per f32 value),
// efbv_update reads g and h and writes d and h_out (16 B); over one
// worker's full qwen2-0.5b gradient (494,032,768 values) 1.18 and 2.36 ms
// at the H100 SXM's 3.35 TB/s.  Issue overtakes the bytes above about 80
// thread instructions per value for block_topk and 160 for efbv_update
// (33.5e12 thread instructions/s).  Issue count (SASS, counted by
// chip_smoke.py with the search's steps replayed on the 14 full-width
// leaves): a step is 4.5 instructions per value at BLOCK 256, 3.5 at 1024,
// 4.9 at 4096; with 12.8-16.4 steps on average, 82 / 94 per value in all
// at 256/16 (block_topk / efbv_update), 74 / 83 at 1024/64, so about as
// much issue as bytes for block_topk and half of it for efbv_update.  The
// dense d and out are the functions' outputs: unlike pack_update.cu,
// nothing stays on chip.
//
// Plain C interface (loaded with ctypes, no PyTorch headers): each entry
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxBlock = 4096;    // rows in registers: at most 1024
                                   // threads of 4 values
constexpr int kBigThreads = 1024;  // a CTA per row above kMaxBlock
// the dynamic shared memory a big row may hold (227 KiB a CTA, less the
// static shared memory)
constexpr int kSmemMax = 227 * 1024 - 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v * keep as the Pallas kernels compute it: a multiply by 1.0 or 0.0, or
// the select that XLA folds an f32 one-round mask into (fault i)
__device__ __forceinline__ float masked(float v, bool keep, bool select) {
  if (select) return keep ? v : 0.0f;
  return __fmul_rn(v, keep ? 1.0f : 0.0f);
}

// out = x * keep over the PER values a thread holds (columns row.col(j))
template <int PER, typename T, class Row>
__device__ __forceinline__ void topk_row(const T* __restrict__ xr,
                                         T* __restrict__ outr, int block,
                                         int kb, Row& r) {
  float v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = to_f32(xr[r.col(j)]);
  const unsigned int sel = block_select::select_mask<PER>(v, kb, block, r);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool keep = (sel >> j) & 1u;
    // f32 at kb = 1 selects: a kept value is stored as read
    outr[r.col(j)] = (sizeof(T) == 4 && kb == 1)
                         ? (keep ? from_f32<T>(v[j]) : from_f32<T>(0.0f))
                         : from_f32<T>(masked(v[j], keep, false));
  }
}

// d = T(delta * keep), h_out = T(h + lam * d) over the PER values a thread
// holds
template <int PER, typename T, class Row>
__device__ __forceinline__ void update_row(const T* __restrict__ g,
                                           const T* __restrict__ h,
                                           T* __restrict__ d_out,
                                           T* __restrict__ h_out, int block,
                                           int kb, float lam,
                                           bool two_roundings, Row& r) {
  float hv[PER];
  float dv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    hv[j] = to_f32(h[r.col(j)]);
    dv[j] = __fsub_rn(to_f32(g[r.col(j)]), hv[j]);
  }
  const unsigned int sel = block_select::select_mask<PER>(dv, kb, block, r);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const T d = from_f32<T>(masked(dv[j], (sel >> j) & 1u, kb == 1));
    const float df = to_f32(d);
    d_out[r.col(j)] = d;
    h_out[r.col(j)] = from_f32<T>(
        two_roundings ? __fadd_rn(hv[j], __fmul_rn(lam, df))
                      : __fmaf_rn(lam, df, hv[j]));
  }
}

// one warp per row of BLOCK <= 1024 values
template <int BLOCK, typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
block_topk_rows(const T* __restrict__ x, T* __restrict__ out, long long nb,
                int kb) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= nb) return;  // whole warps: the shuffles stay full
  block_select::WarpRow r{(int)(threadIdx.x & 31)};
  topk_row<BLOCK / 32>(x + row * BLOCK, out + row * BLOCK, BLOCK, kb, r);
}

template <int BLOCK, typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
efbv_update_rows(const T* __restrict__ g, const T* __restrict__ h,
                 T* __restrict__ d_out, T* __restrict__ h_out, long long nb,
                 int kb, float lam, bool two_roundings) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= nb) return;
  block_select::WarpRow r{(int)(threadIdx.x & 31)};
  const long long base = row * BLOCK;
  update_row<BLOCK / 32>(g + base, h + base, d_out + base, h_out + base,
                         BLOCK, kb, lam, two_roundings, r);
}

// one CTA of block / PER threads per row
template <int PER, typename T>
__global__ void __launch_bounds__(kMaxBlock / PER)
block_topk_cta(const T* __restrict__ x, T* __restrict__ out, int block,
               int kb) {
  __shared__ int sums[64];
  block_select::CtaRow r{sums, (int)(threadIdx.x >> 5),
                         (int)(threadIdx.x & 31), (int)(blockDim.x >> 5), 0};
  const long long base = (long long)blockIdx.x * block;
  topk_row<PER>(x + base, out + base, block, kb, r);
}

template <int PER, typename T>
__global__ void __launch_bounds__(kMaxBlock / PER)
efbv_update_cta(const T* __restrict__ g, const T* __restrict__ h,
                T* __restrict__ d_out, T* __restrict__ h_out, int block,
                int kb, float lam, bool two_roundings) {
  __shared__ int sums[64];
  block_select::CtaRow r{sums, (int)(threadIdx.x >> 5),
                         (int)(threadIdx.x & 31), (int)(blockDim.x >> 5), 0};
  const long long base = (long long)blockIdx.x * block;
  update_row<PER>(g + base, h + base, d_out + base, h_out + base, block, kb,
                  lam, two_roundings, r);
}

// Rows above kMaxBlock: one CTA of kBigThreads per row, the row read again
// at each step of the search (block_select::select_cut) from shared memory
// (ROW_SMEM: as f32, staged once) or, where it does not fit, from device
// memory.

template <typename T>
struct GlobalX {  // x as f32
  const T* x;
  __device__ __forceinline__ float operator()(int c) const {
    return to_f32(x[c]);
  }
};

template <typename T>
struct GlobalDelta {  // f32(g) - f32(h)
  const T* g;
  const T* h;
  __device__ __forceinline__ float operator()(int c) const {
    return __fsub_rn(to_f32(g[c]), to_f32(h[c]));
  }
};

struct SharedRow {
  const float* s;
  __device__ __forceinline__ float operator()(int c) const { return s[c]; }
};

extern __shared__ __align__(16) float big_row_smem[];

__device__ __forceinline__ block_select::CtaRow big_row(int* sums) {
  return block_select::CtaRow{sums, (int)(threadIdx.x >> 5),
                              (int)(threadIdx.x & 31), kBigThreads / 32, 0};
}

// the row's cut: the values staged into shared memory first when ROW_SMEM
template <bool ROW_SMEM, class Src>
__device__ __forceinline__ block_select::Cut big_cut(const Src& src,
                                                     int block, int kb,
                                                     block_select::CtaRow& r) {
  if (!ROW_SMEM) return block_select::select_cut(src, kb, block, r);
  for (int c = threadIdx.x; c < block; c += kBigThreads)
    big_row_smem[c] = src(c);
  __syncthreads();
  return block_select::select_cut(SharedRow{big_row_smem}, kb, block, r);
}

template <bool ROW_SMEM, typename T>
__global__ void __launch_bounds__(kBigThreads)
block_topk_big(const T* __restrict__ x, T* __restrict__ out, int block,
               int kb) {
  __shared__ int sums[64];
  block_select::CtaRow r = big_row(sums);
  const long long base = (long long)blockIdx.x * block;
  const GlobalX<T> src{x + base};
  const block_select::Cut cut = big_cut<ROW_SMEM>(src, block, kb, r);
  for (int c = threadIdx.x; c < block; c += kBigThreads) {
    const float v = ROW_SMEM ? big_row_smem[c] : src(c);
    const bool keep = cut.keep(fabsf(v), c);
    // f32 at kb = 1 selects: a kept value is stored as read
    out[base + c] = (sizeof(T) == 4 && kb == 1)
                        ? (keep ? from_f32<T>(v) : from_f32<T>(0.0f))
                        : from_f32<T>(masked(v, keep, false));
  }
}

template <bool ROW_SMEM, typename T>
__global__ void __launch_bounds__(kBigThreads)
efbv_update_big(const T* __restrict__ g, const T* __restrict__ h,
                T* __restrict__ d_out, T* __restrict__ h_out, int block,
                int kb, float lam, bool two_roundings) {
  __shared__ int sums[64];
  block_select::CtaRow r = big_row(sums);
  const long long base = (long long)blockIdx.x * block;
  const GlobalDelta<T> src{g + base, h + base};
  const block_select::Cut cut = big_cut<ROW_SMEM>(src, block, kb, r);
  for (int c = threadIdx.x; c < block; c += kBigThreads) {
    const float delta = ROW_SMEM ? big_row_smem[c] : src(c);
    const float hv = to_f32(h[base + c]);
    const T d = from_f32<T>(masked(delta, cut.keep(fabsf(delta), c),
                                   kb == 1));
    const float df = to_f32(d);
    d_out[base + c] = d;
    h_out[base + c] = from_f32<T>(two_roundings
                                      ? __fadd_rn(hv, __fmul_rn(lam, df))
                                      : __fmaf_rn(lam, df, hv));
  }
}

// above 48 KiB of shared memory a kernel must opt in to its dynamic shared
// memory: opt in to the most asked for so far
template <typename K>
int opt_in(K kernel, size_t smem, size_t& opted_in) {
  if (smem <= opted_in) return (int)cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) opted_in = smem;
  return (int)e;
}

template <typename T>
int launch_topk_big(const T* x, T* out, long long nb, int block, int kb,
                    cudaStream_t s) {
  const size_t smem = (size_t)block * 4;
  if (smem > (size_t)kSmemMax) {
    block_topk_big<false, T><<<(unsigned int)nb, kBigThreads, 0, s>>>(
        x, out, block, kb);
    return (int)cudaGetLastError();
  }
  static size_t opted_in = 0;
  if (const int e = opt_in(block_topk_big<true, T>, smem, opted_in))
    return e;
  block_topk_big<true, T><<<(unsigned int)nb, kBigThreads, smem, s>>>(
      x, out, block, kb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update_big(const T* g, const T* h, T* d, T* h_out, long long nb,
                      int block, int kb, float lam, bool two,
                      cudaStream_t s) {
  const size_t smem = (size_t)block * 4;
  if (smem > (size_t)kSmemMax) {
    efbv_update_big<false, T><<<(unsigned int)nb, kBigThreads, 0, s>>>(
        g, h, d, h_out, block, kb, lam, two);
    return (int)cudaGetLastError();
  }
  static size_t opted_in = 0;
  if (const int e = opt_in(efbv_update_big<true, T>, smem, opted_in))
    return e;
  efbv_update_big<true, T><<<(unsigned int)nb, kBigThreads, smem, s>>>(
      g, h, d, h_out, block, kb, lam, two);
  return (int)cudaGetLastError();
}

unsigned int ctas(long long nb) {
  return (unsigned int)((nb + kWarpsPerCta - 1) / kWarpsPerCta);
}

template <int BLOCK, typename T>
int launch_topk(const T* x, T* out, long long nb, int kb, cudaStream_t s) {
  block_topk_rows<BLOCK, T><<<ctas(nb), kWarpsPerCta * 32, 0, s>>>(x, out,
                                                                   nb, kb);
  return (int)cudaGetLastError();
}

template <int BLOCK, typename T>
int launch_update(const T* g, const T* h, T* d, T* h_out, long long nb,
                  int kb, float lam, bool two, cudaStream_t s) {
  efbv_update_rows<BLOCK, T><<<ctas(nb), kWarpsPerCta * 32, 0, s>>>(
      g, h, d, h_out, nb, kb, lam, two);
  return (int)cudaGetLastError();
}

// argument checks shared by the entries; cudaSuccess when the call is fine
int check(long long nb, int block, int kb) {
  if (kb <= 0 || kb > block || block % 128)
    return (int)cudaErrorInvalidValue;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSuccess;
}

#define WARP_BLOCKS(F) \
  F(128) F(256) F(384) F(512) F(640) F(768) F(896) F(1024)

template <typename T>
int block_topk(const T* x, T* out, long long nb, int block, int kb,
               void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (const int e = check(nb, block, kb)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
#define CASE(B) \
  case B:       \
    return launch_topk<B, T>(x, out, nb, kb, s);
    WARP_BLOCKS(CASE)
#undef CASE
    default:
      if (block > kMaxBlock)
        return launch_topk_big<T>(x, out, nb, block, kb, s);
      // the most values a thread that leave whole warps
      if (block % 512 == 0)
        block_topk_cta<16, T><<<(unsigned int)nb, block / 16, 0, s>>>(
            x, out, block, kb);
      else if (block % 256 == 0)
        block_topk_cta<8, T><<<(unsigned int)nb, block / 8, 0, s>>>(
            x, out, block, kb);
      else
        block_topk_cta<4, T><<<(unsigned int)nb, block / 4, 0, s>>>(
            x, out, block, kb);
      return (int)cudaGetLastError();
  }
}

template <typename T>
int efbv_update(const T* g, const T* h, T* d, T* h_out, long long nb,
                int block, int kb, float lam, int fused, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (const int e = check(nb, block, kb)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // f32 at kb = 1: a multiply then an add, unless the caller asks for the
  // one fused op (one unreshaped (8, block) tile: ROADMAP fault m)
  const bool two = sizeof(T) == 4 && kb == 1 && !fused;
  switch (block) {
#define CASE(B) \
  case B:       \
    return launch_update<B, T>(g, h, d, h_out, nb, kb, lam, two, s);
    WARP_BLOCKS(CASE)
#undef CASE
    default:
      if (block > kMaxBlock)
        return launch_update_big<T>(g, h, d, h_out, nb, block, kb, lam, two,
                                    s);
      if (block % 512 == 0)
        efbv_update_cta<16, T><<<(unsigned int)nb, block / 16, 0, s>>>(
            g, h, d, h_out, block, kb, lam, two);
      else if (block % 256 == 0)
        efbv_update_cta<8, T><<<(unsigned int)nb, block / 8, 0, s>>>(
            g, h, d, h_out, block, kb, lam, two);
      else
        efbv_update_cta<4, T><<<(unsigned int)nb, block / 4, 0, s>>>(
            g, h, d, h_out, block, kb, lam, two);
      return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" int block_topk_f32(const float* x, float* out, long long nb,
                              int block, int kb, void* stream) {
  return block_topk<float>(x, out, nb, block, kb, stream);
}

extern "C" int block_topk_bf16(const __nv_bfloat16* x, __nv_bfloat16* out,
                               long long nb, int block, int kb,
                               void* stream) {
  return block_topk<__nv_bfloat16>(x, out, nb, block, kb, stream);
}

extern "C" int efbv_update_f32(const float* g, const float* h, float* d,
                               float* h_out, long long nb, int block, int kb,
                               float lam, int fused, void* stream) {
  return efbv_update<float>(g, h, d, h_out, nb, block, kb, lam, fused,
                            stream);
}

extern "C" int efbv_update_bf16(const __nv_bfloat16* g,
                                const __nv_bfloat16* h, __nv_bfloat16* d,
                                __nv_bfloat16* h_out, long long nb,
                                int block, int kb, float lam, int fused,
                                void* stream) {
  return efbv_update<__nv_bfloat16>(g, h, d, h_out, nb, block, kb, lam,
                                    fused, stream);
}
