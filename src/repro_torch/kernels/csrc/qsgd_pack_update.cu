// Fused QSGD quantize-and-pack with the EF-BV control-variate update, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pack.py::_qsgd_pack_kernel (the Pallas TPU
// kernel behind qsgd_pack_update_pallas).
//
// Per element of a flat leaf, with delta = g - h in f32, the uniform draw u
// and the leaf's norm = ||g - h||_2 (computed outside, as in the Pallas
// kernel, and read from device memory so the host never waits for it):
//   safe   = norm > 0 ? norm : 1            (a NaN norm gives 1)
//   level  = (|delta| / safe) * s
//   low    = floor(level)
//   up     = u < level - low ? 1 : 0
//   sgn    = delta > 0 ? 1 : delta < 0 ? -1 : 0
//   lvq    = low + up
//   levels = L(sgn * lvq)                   (int8 for s <= 127, else int16)
//   dq     = lvq > 0 ? (norm * sgn) * (lvq * inv_s) : 0
//   h_out  = h + lam * dq
// with inv_s the f32-rounded 1/s.  Every op is a rounded intrinsic
// (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn): IEEE division, and no FMA
// contraction of the tail, as in the Pallas kernel.  The conversion to L is
// XLA's: NaN becomes 0 and values beyond L saturate.  So a NaN in delta
// (which makes the norm NaN) gives level 0 and h + lam * 0 in that lane, and
// a NaN h_out in every lane with lvq > 0.
//
// Layout: flat leaves need no padding.  Each thread takes 4 consecutive
// values (16-byte loads of g, h and u, one 4- or 8-byte store of levels, a
// 16-byte store of h_out) in a grid-stride loop; a leaf whose pointers are
// not so aligned, and the size % 4 tail, go one value at a time.
//
// Bound: memory.  Each value reads g, h, u (12 B) and writes its level (1 B
// at s <= 127) and h_out (4 B): 17 B.  For one worker's full qwen2-0.5b
// gradient (494,032,768 values) that is 8.40 GB, 2.51 ms at the H100 SXM's
// 3.35 TB/s.  About 20 f32 operations per value stay far below that.
//
// Plain C interface (loaded with ctypes, no PyTorch headers): the launcher
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename L>
__device__ __forceinline__ L to_level(float x);

template <>
__device__ __forceinline__ int8_t to_level<int8_t>(float x) {
  if (isnan(x)) return 0;
  return (int8_t)(int)fminf(fmaxf(x, -128.0f), 127.0f);
}

template <>
__device__ __forceinline__ int16_t to_level<int16_t>(float x) {
  if (isnan(x)) return 0;
  return (int16_t)(int)fminf(fmaxf(x, -32768.0f), 32767.0f);
}

struct Params {
  float norm, safe, s, inv_s, lam;
};

template <typename L>
__device__ __forceinline__ void quantize(float g, float h, float u,
                                         const Params& p, L& lvl,
                                         float& h_out) {
  const float delta = __fsub_rn(g, h);
  const float level = __fmul_rn(__fdiv_rn(fabsf(delta), p.safe), p.s);
  const float low = floorf(level);
  const float up = (u < __fsub_rn(level, low)) ? 1.0f : 0.0f;
  const float sgn = delta > 0.0f ? 1.0f : (delta < 0.0f ? -1.0f : 0.0f);
  const float lvq = __fadd_rn(low, up);
  lvl = to_level<L>(__fmul_rn(sgn, lvq));
  const float dq = lvq > 0.0f
      ? __fmul_rn(__fmul_rn(p.norm, sgn), __fmul_rn(lvq, p.inv_s))
      : 0.0f;
  h_out = __fadd_rn(h, __fmul_rn(p.lam, dq));
}

template <typename L>
struct Vec4;
template <>
struct Vec4<int8_t> { using T = char4; };
template <>
struct Vec4<int16_t> { using T = short4; };

template <typename L, bool VEC>
__global__ void __launch_bounds__(kThreads)
qsgd_pack_update_kernel(const float* __restrict__ g,
                        const float* __restrict__ h,
                        const float* __restrict__ u,
                        const float* __restrict__ norm_ptr,
                        L* __restrict__ levels, float* __restrict__ h_out,
                        long long size, float s, float inv_s, float lam) {
  Params p;
  p.norm = *norm_ptr;
  p.safe = p.norm > 0.0f ? p.norm : 1.0f;
  p.s = s;
  p.inv_s = inv_s;
  p.lam = lam;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long quads = size / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* h4 = reinterpret_cast<const float4*>(h);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    float4* o4 = reinterpret_cast<float4*>(h_out);
    using LV = typename Vec4<L>::T;
    LV* l4 = reinterpret_cast<LV*>(levels);
    for (long long q = tid; q < quads; q += stride) {
      const float4 gv = g4[q], hv = h4[q], uv = u4[q];
      float4 ov;
      L a, b, c, d;
      quantize<L>(gv.x, hv.x, uv.x, p, a, ov.x);
      quantize<L>(gv.y, hv.y, uv.y, p, b, ov.y);
      quantize<L>(gv.z, hv.z, uv.z, p, c, ov.z);
      quantize<L>(gv.w, hv.w, uv.w, p, d, ov.w);
      LV lv;
      lv.x = a; lv.y = b; lv.z = c; lv.w = d;
      o4[q] = ov;
      l4[q] = lv;
    }
    done = 4 * quads;
  }
  for (long long i = done + tid; i < size; i += stride) {
    quantize<L>(g[i], h[i], u[i], p, levels[i], h_out[i]);
  }
}

template <typename L>
int launch(const float* g, const float* h, const float* u, const float* norm,
           void* levels, float* h_out, long long size, float s, float inv_s,
           float lam, cudaStream_t stream) {
  const auto a16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = a16(g) && a16(h) && a16(u) && a16(h_out) &&
                   reinterpret_cast<uintptr_t>(levels) % (4 * sizeof(L)) == 0;
  const long long work = vec ? size / 4 : size;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  L* lv = static_cast<L*>(levels);
  if (vec)
    qsgd_pack_update_kernel<L, true><<<(unsigned int)blocks, kThreads, 0,
                                       stream>>>(g, h, u, norm, lv, h_out,
                                                 size, s, inv_s, lam);
  else
    qsgd_pack_update_kernel<L, false><<<(unsigned int)blocks, kThreads, 0,
                                        stream>>>(g, h, u, norm, lv, h_out,
                                                  size, s, inv_s, lam);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qsgd_pack_update_f32(const float* g, const float* h,
                                    const float* u, const float* norm,
                                    void* levels, float* h_out,
                                    long long size, int s, float inv_s,
                                    float lam, int level_bytes,
                                    void* stream) {
  if (size <= 0) return (int)cudaSuccess;
  if (s < 1 || s > 32767) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (level_bytes == 1 && s <= 127)
    return launch<int8_t>(g, h, u, norm, levels, h_out, size, (float)s,
                          inv_s, lam, st);
  if (level_bytes == 2 && s > 127)
    return launch<int16_t>(g, h, u, norm, levels, h_out, size, (float)s,
                           inv_s, lam, st);
  return (int)cudaErrorInvalidValue;
}
