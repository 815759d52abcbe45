// Counter-based threefry2x32 draws for Hopper (sm_90a), bit for bit those of
// jax.random under jax_threefry_partitionable (jax 0.9.0).
//
// Replaces no Pallas kernel: the JAX package draws the QSGD uniforms with
// jax.random.uniform (src/repro/distributed/wire.py QsgdQuant), which XLA
// compiles; the port draws them here.
//
// Element i of a draw of n under key (k0, k1):
//   (y0, y1) = threefry2x32((k0, k1), (i >> 32, i & 0xFFFFFFFF))
//   word_i   = y0 ^ y1
//   out_i    = as_float ? f32(word_i >> 9 | 0x3F800000) - 1.0f : word_i
// threefry2x32 is 20 rounds (rotations 13 15 26 6 / 17 29 16 24) with a key
// injection after every 4, key schedule k2 = k0 ^ k1 ^ 0x1BD11BDA.  The
// float conversion is exact: a float in [1, 2) minus 1.0.
//
// Layout: each thread draws 4 consecutive elements and writes them as one
// 16-byte store (a scalar tail for n % 4), in a grid-stride loop.
//
// Bound: about 80 32-bit integer operations per element (20 x (add, rotate,
// xor), 6 injections, the xor and float conversion) against 4 bytes written;
// on the H100 the integer pipes, not memory, are the limit.
//
// Plain C interface (loaded with ctypes, no PyTorch headers): the launcher
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)   \
  x0 += x1;           \
  x1 = rotl(x1, r);   \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t k2,
                                                  unsigned long long i) {
  uint32_t x0 = (uint32_t)(i >> 32) + k0;
  uint32_t x1 = (uint32_t)(i & 0xffffffffull) + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_ROUND

__device__ __forceinline__ uint32_t to_out(uint32_t w, int as_float) {
  if (!as_float) return w;
  const float f = __fsub_rn(__uint_as_float((w >> 9) | 0x3f800000u), 1.0f);
  return __float_as_uint(f);
}

__global__ void __launch_bounds__(kThreads)
threefry_fill_kernel(uint32_t k0, uint32_t k1, uint32_t* __restrict__ out,
                     long long n, int as_float) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1bd11bdau;
  const long long quads = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    const unsigned long long i = 4ull * (unsigned long long)q;
    uint4 v;
    v.x = to_out(threefry_word(k0, k1, k2, i), as_float);
    v.y = to_out(threefry_word(k0, k1, k2, i + 1), as_float);
    v.z = to_out(threefry_word(k0, k1, k2, i + 2), as_float);
    v.w = to_out(threefry_word(k0, k1, k2, i + 3), as_float);
    out4[q] = v;
  }
  // the n % 4 tail, one element per thread of the first block
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const long long i = 4 * quads + threadIdx.x;
    out[i] = to_out(threefry_word(k0, k1, k2, (unsigned long long)i),
                    as_float);
  }
}

}  // namespace

extern "C" int threefry_fill(unsigned int k0, unsigned int k1, void* out,
                             long long n, int as_float, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  // 16-byte stores need a 16-byte aligned output
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long quads = n / 4;
  long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  threefry_fill_kernel<<<(unsigned int)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<uint32_t*>(out), n, as_float);
  return (int)cudaGetLastError();
}
