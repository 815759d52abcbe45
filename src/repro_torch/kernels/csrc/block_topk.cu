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
//     (__fmul_rn then __fadd_rn; nvcc would contract them otherwise);
//   * bf16 values are read exactly into f32, and d and h_out are rounded
//     back to nearest even (__float2bfloat16, as torch rounds on the card).
//
// Layout: one warp per row, the row in registers (BLOCK / 32 values per
// lane, coalesced 128-byte loads and stores of f32, 64-byte of bf16), 8
// rows per CTA.  Instantiated for every BLOCK % 128 == 0 from 128 to 1024;
// the wrapper refuses larger blocks.
//
// Bound: memory at small kb.  block_topk reads x and writes out (8 B per
// f32 value), efbv_update reads g and h and writes d and h_out (16 B); over
// one worker's full qwen2-0.5b gradient (494,032,768 values) 1.18 and 2.36
// ms at the H100 SXM's 3.35 TB/s.  The selection (block_select.cuh)
// issues 12 thread instructions per value and round at BLOCK 256, 6.75 at
// 1024: 2.83 ms over those values at kb 16 and BLOCK 256, so it, not the
// bytes, sets this design's time.  The dense d and out are the functions'
// outputs: unlike pack_update.cu, nothing stays on chip.
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

template <int BLOCK, typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
block_topk_rows(const T* __restrict__ x, T* __restrict__ out, long long nb,
                int kb) {
  constexpr int PER = BLOCK / 32;
  const long long row =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= nb) return;  // whole warps: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * BLOCK;
  T* outr = out + row * BLOCK;

  float v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = to_f32(xr[j * 32 + lane]);
  const unsigned int sel = block_select::select_mask<PER>(v, kb, lane);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * 32 + lane;
    const bool keep = (sel >> j) & 1u;
    // f32 at kb = 1 selects: a kept value is stored as read
    outr[c] = (sizeof(T) == 4 && kb == 1)
                  ? (keep ? xr[c] : from_f32<T>(0.0f))
                  : from_f32<T>(masked(v[j], keep, false));
  }
}

template <int BLOCK, typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
efbv_update_rows(const T* __restrict__ g, const T* __restrict__ h,
                 T* __restrict__ d_out, T* __restrict__ h_out, long long nb,
                 int kb, float lam) {
  constexpr int PER = BLOCK / 32;
  const long long row =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= nb) return;
  const int lane = threadIdx.x & 31;
  const long long base = row * BLOCK;

  float hv[PER];
  float dv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * 32 + lane;
    hv[j] = to_f32(h[base + c]);
    dv[j] = __fsub_rn(to_f32(g[base + c]), hv[j]);
  }
  const unsigned int sel = block_select::select_mask<PER>(dv, kb, lane);
  // f32 at kb = 1: a multiply then an add; otherwise one fused op
  const bool two_roundings = sizeof(T) == 4 && kb == 1;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * 32 + lane;
    const T d = from_f32<T>(masked(dv[j], (sel >> j) & 1u, kb == 1));
    const float df = to_f32(d);
    d_out[base + c] = d;
    h_out[base + c] = from_f32<T>(
        two_roundings ? __fadd_rn(hv[j], __fmul_rn(lam, df))
                      : __fmaf_rn(lam, df, hv[j]));
  }
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
                  int kb, float lam, cudaStream_t s) {
  efbv_update_rows<BLOCK, T><<<ctas(nb), kWarpsPerCta * 32, 0, s>>>(
      g, h, d, h_out, nb, kb, lam);
  return (int)cudaGetLastError();
}

// argument checks shared by the entries; cudaSuccess when the call is fine
int check(long long nb, int block, int kb) {
  if (kb <= 0 || kb > block) return (int)cudaErrorInvalidValue;
  if ((nb + kWarpsPerCta - 1) / kWarpsPerCta > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSuccess;
}

#define BLOCK_CASES(F) \
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
    BLOCK_CASES(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int efbv_update(const T* g, const T* h, T* d, T* h_out, long long nb,
                int block, int kb, float lam, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (const int e = check(nb, block, kb)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
#define CASE(B) \
  case B:       \
    return launch_update<B, T>(g, h, d, h_out, nb, kb, lam, s);
    BLOCK_CASES(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
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
                               float lam, void* stream) {
  return efbv_update<float>(g, h, d, h_out, nb, block, kb, lam, stream);
}

extern "C" int efbv_update_bf16(const __nv_bfloat16* g,
                                const __nv_bfloat16* h, __nv_bfloat16* d,
                                __nv_bfloat16* h_out, long long nb,
                                int block, int kb, float lam, void* stream) {
  return efbv_update<__nv_bfloat16>(g, h, d, h_out, nb, block, kb, lam,
                                    stream);
}
