// Rand-k control-variate update for Hopper (sm_90a): the payload values and
// h_out = h + lam * d of one flat leaf, with d the rand-k compression of
// g - h at k given positions.
//
// Replaces: src/repro/kernels/pack.py::_randk_update_kernel (the Pallas TPU
// kernel behind randk_update_pallas).
//
// With idx the k selected flat positions (drawn outside, by the shuffle of
// jax.random.choice) and scale = f32(size / k):
//   d[p]   = (g[p] - h[p]) * scale   at p = idx[j],  0 elsewhere
//   vals_j = d[idx[j]]               (the wire payload's values)
//   h_out  = h + lam * d
// each op rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nvcc would
// contract the tail into an FMA), as in the Pallas kernel.  An unselected
// position takes h + lam * 0.0, as the Pallas kernel's where(mask, ., 0.0)
// gives it: -0.0 becomes +0.0, and a NaN stays a NaN.
//
// Design.  The Pallas kernel rebuilds the selection mask of every (8, 1024)
// tile from the index list in SMEM (an f32 iota compare, k steps per tile).
// None of that carries over: here two passes on the same stream.
//   1. dense: h_out = h + lam * 0.0 at every position, 16-byte loads and
//      stores where h and h_out allow, one value at a time otherwise;
//   2. sparse: one thread per selected position p = idx[j] reads g[p] and
//      h[p] (from h, never from h_out) and writes vals[j] and h_out[p].
// Positions are unique (a duplicate would write the same value twice).  A
// position outside [0, size) traps: the launch fails, it is never skipped.
//
// Bound: memory.  Pass 1 reads h and writes h_out (8 B per value); pass 2
// reads idx, g[p], h[p] and writes vals and h_out[p] (20 B per selected
// value).  The kernel has no size limit of its own; the f32 compare that
// limits the Pallas kernel to 2**24 values is gone.
//
// Plain C interface (loaded with ctypes, no PyTorch headers): the launcher
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
randk_dense_kernel(const float* __restrict__ h, float* __restrict__ h_out,
                   long long size, float lam) {
  const float zero = __fmul_rn(lam, 0.0f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long quads = size / 4;
    const float4* h4 = reinterpret_cast<const float4*>(h);
    float4* o4 = reinterpret_cast<float4*>(h_out);
    for (long long q = tid; q < quads; q += stride) {
      float4 v = h4[q];
      v.x = __fadd_rn(v.x, zero);
      v.y = __fadd_rn(v.y, zero);
      v.z = __fadd_rn(v.z, zero);
      v.w = __fadd_rn(v.w, zero);
      o4[q] = v;
    }
    done = 4 * quads;
  }
  for (long long i = done + tid; i < size; i += stride) {
    h_out[i] = __fadd_rn(h[i], zero);
  }
}

__global__ void __launch_bounds__(kThreads)
randk_sparse_kernel(const float* __restrict__ g, const float* __restrict__ h,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ vals, float* __restrict__ h_out,
                    long long size, long long k, float scale, float lam) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < k; j += stride) {
    const int32_t p = idx[j];
    if (p < 0 || (long long)p >= size) __trap();
    const float hp = h[p];
    const float v = __fmul_rn(__fsub_rn(g[p], hp), scale);
    vals[j] = v;
    h_out[p] = __fadd_rn(hp, __fmul_rn(lam, v));
  }
}

unsigned int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  return (unsigned int)blocks;
}

}  // namespace

extern "C" int randk_update_f32(const float* g, const float* h,
                                const int32_t* idx, float* vals,
                                float* h_out, long long size, long long k,
                                float scale, float lam, void* stream) {
  if (size <= 0) return (int)cudaSuccess;
  if (k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto a16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (a16(h) && a16(h_out))
    randk_dense_kernel<true><<<grid_for(size / 4), kThreads, 0, st>>>(
        h, h_out, size, lam);
  else
    randk_dense_kernel<false><<<grid_for(size), kThreads, 0, st>>>(
        h, h_out, size, lam);
  int err = (int)cudaGetLastError();
  if (err != 0 || k == 0) return err;
  randk_sparse_kernel<<<grid_for(k), kThreads, 0, st>>>(
      g, h, idx, vals, h_out, size, k, scale, lam);
  return (int)cudaGetLastError();
}
