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
// 16-byte store (a scalar tail for n % 4), in a grid-stride loop.  The 4
// counters share their high word (4 divides 2**32), and below 2**32 words
// the loop counts in 32 bits with that word the constant 0.
//
// The row draw (threefry_rows) is the same draw under n keys at once, as
// vmap over a worker axis draws it: element (i, c) of an (n, m) output is
// word(keys[i], c), the key pair read from device memory (n x 2 uint32,
// copied once per call).  A 2-D grid: blockIdx.y strides over the rows,
// the x dimension over the row's groups of 4 columns; a row of m % 4 == 0
// values is written with 16-byte stores, any other row value by value
// (two instantiations of one template, so each loop is straight code).
//
// Bound: about 72 SASS instructions per element (20 x (add, rotate, xor),
// the injections, the xor, the float conversion, the loop) against 4 bytes
// written: on the H100 the issue of instructions (128 a clock per SM), not
// memory, is the limit.  The integer pipe is not: the card ran a loop of
// 48.75 integer-pipe instructions a value faster than 64 of them a clock
// per SM allow.  So a core that moves rotations and adds to the FMA
// pipe (IMAD, IMAD.WIDE) buys nothing and costs issue slots; such cores
// were measured slower (PERF.md, section 6).
//
// The row shuffle (threefry_shuffle_rows) is random.permutation_rows and
// choice_rows in one launch: jax.random's shuffle of arange(m) under vmap
// over n keys, every round and the cut to the first k columns.  Replaces
// no Pallas kernel (JAX's shuffle is XLA's sort); it replaces the seven
// launches of each round of the composition it equals (arange, repeat, the
// row draw, xor, a segmented stable torch.sort, gather, the cut), which
// cost microseconds of launch each for under one of work at the reference
// round's (1000, 56).  A CTA per row holds the row's x in shared memory;
// each round draws the row's m words under that round's key (counter
// (0, c), as threefry_rows), forms the 64-bit keys word << 32 | c (all
// distinct, so an ascending sort of them is JAX's stable sort of the words
// read as uint32, lax.sort_key_val's tie rule), sorts them by a bitonic
// network over the next power of two p (padded with UINT64_MAX, last),
// and permutes x by the sorted columns; the CTA writes only the first k
// columns.  Shared memory: 8 B of key a slot and 4 B of x a column (the
// gathered x goes through the key slots), 8 p + 4 m bytes: up to m =
// 16384 (196,608 B of the 227 KB a block can use).  Wider rows take the
// row draw, torch.sort and gather (the wrapper's plan).  Bound: the
// bitonic network's (p / 2) log p (log p + 1) / 2 compare-exchanges and the
// draws at the issue rate; at (1000, 56) the launch and the network's 21
// barriers, not bytes or instructions, set the time.
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

// the word of counter (hi, lo) under the key schedule (k0, k1, k2)
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t hi,
                                                  uint32_t lo) {
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
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

// Index: the loop's integer type, 32 bits below 2**32 words (the counters'
// high word then the constant 0)
template <typename Index>
__global__ void __launch_bounds__(kThreads)
threefry_fill_kernel(uint32_t k0, uint32_t k1, uint32_t* __restrict__ out,
                     Index n, int as_float) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1bd11bdau;
  const Index quads = n / 4;
  const Index stride = (Index)gridDim.x * blockDim.x;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (Index q = (Index)blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride) {
    const unsigned long long i = 4ull * q;
    const uint32_t hi = sizeof(Index) == 4 ? 0u : (uint32_t)(i >> 32);
    const uint32_t lo = (uint32_t)i;
    uint4 v;
    v.x = to_out(threefry_word(k0, k1, k2, hi, lo), as_float);
    v.y = to_out(threefry_word(k0, k1, k2, hi, lo + 1u), as_float);
    v.z = to_out(threefry_word(k0, k1, k2, hi, lo + 2u), as_float);
    v.w = to_out(threefry_word(k0, k1, k2, hi, lo + 3u), as_float);
    out4[q] = v;
  }
  // the n % 4 tail, one element per thread of the first block
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const unsigned long long i = 4ull * quads + threadIdx.x;
    out[i] = to_out(threefry_word(k0, k1, k2, (uint32_t)(i >> 32),
                                  (uint32_t)i),
                    as_float);
  }
}

template <bool kQuad>
__global__ void __launch_bounds__(kThreads)
threefry_rows_kernel(const uint32_t* __restrict__ keys, long long rows,
                     unsigned int m, uint32_t* __restrict__ out,
                     int as_float) {
  const unsigned int quads = (m + 3u) / 4u;
  const unsigned int stride = gridDim.x * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t k0 = keys[2 * r], k1 = keys[2 * r + 1];
    const uint32_t k2 = k0 ^ k1 ^ 0x1bd11bdau;
    uint32_t* row = out + r * (long long)m;
    for (unsigned int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads;
         q += stride) {
      const unsigned int c = 4u * q;
      if (kQuad) {
        uint4 v;
        v.x = to_out(threefry_word(k0, k1, k2, 0u, c), as_float);
        v.y = to_out(threefry_word(k0, k1, k2, 0u, c + 1), as_float);
        v.z = to_out(threefry_word(k0, k1, k2, 0u, c + 2), as_float);
        v.w = to_out(threefry_word(k0, k1, k2, 0u, c + 3), as_float);
        reinterpret_cast<uint4*>(row)[q] = v;
      } else {
        for (unsigned int j = c; j < c + 4u && j < m; ++j)
          row[j] = to_out(threefry_word(k0, k1, k2, 0u, j), as_float);
      }
    }
  }
}

constexpr int kShuffleThreads = 1024;

// keys: (rounds * rows, 2), round r's key of row i at r * rows + i
__global__ void __launch_bounds__(kShuffleThreads)
threefry_shuffle_rows_kernel(const uint32_t* __restrict__ keys,
                             long long rows, unsigned int m, unsigned int p,
                             unsigned int k, int rounds,
                             int* __restrict__ out) {
  extern __shared__ unsigned long long slot[];             // p sort keys
  uint32_t* x = reinterpret_cast<uint32_t*>(slot + p);     // m values
  const unsigned int tid = threadIdx.x, nt = blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    for (unsigned int c = tid; c < m; c += nt) x[c] = c;
    for (int round = 0; round < rounds; ++round) {
      const long long kr = 2 * ((long long)round * rows + r);
      const uint32_t k0 = keys[kr], k1 = keys[kr + 1];
      const uint32_t k2 = k0 ^ k1 ^ 0x1bd11bdau;
      for (unsigned int c = tid; c < p; c += nt)
        slot[c] = c < m ? (unsigned long long)threefry_word(k0, k1, k2, 0u,
                                                            c) << 32 | c
                        : ~0ull;
      __syncthreads();
      // bitonic network, ascending: pair i of a stage is (a, a + stride)
      for (unsigned int size = 2; size <= p; size <<= 1) {
        for (unsigned int stride = size >> 1; stride > 0; stride >>= 1) {
          for (unsigned int i = tid; i < p / 2; i += nt) {
            const unsigned int a =
                (i & ~(stride - 1)) << 1 | (i & (stride - 1));
            const unsigned long long ka = slot[a], kb = slot[a + stride];
            if ((ka > kb) == ((a & size) == 0)) {
              slot[a] = kb;
              slot[a + stride] = ka;
            }
          }
          __syncthreads();
        }
      }
      // x[i] <- x[column of the i-th smallest key], through the key slots
      for (unsigned int i = tid; i < m; i += nt)
        slot[i] = x[(uint32_t)slot[i]];
      __syncthreads();
      for (unsigned int i = tid; i < m; i += nt) x[i] = (uint32_t)slot[i];
      __syncthreads();
    }
    int* row = out + r * (long long)k;
    for (unsigned int i = tid; i < k; i += nt) row[i] = (int)x[i];
    __syncthreads();  // the next row rewrites x
  }
}

}  // namespace

// out (rows, k) int32: the first k columns of each row's shuffle of
// arange(m) by `rounds` rounds under keys (rounds * rows, 2).  Which rows
// come here is the wrapper's plan (threefry.SHUFFLE_MAX_M); a row whose
// 8 p + 4 m bytes exceed a block's shared memory is refused
extern "C" int threefry_shuffle_rows(const void* keys, long long rows,
                                     long long m, long long k, int rounds,
                                     void* out, void* stream) {
  if (rows <= 0 || k <= 0) return (int)cudaSuccess;
  if (m <= 0 || m >= (1ll << 31) || k > m || rounds < 0)
    return (int)cudaErrorInvalidValue;
  long long p = 1;
  while (p < m) p <<= 1;
  const long long smem = 8 * p + 4 * m;
  int device = 0, most = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem > most) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(threefry_shuffle_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a thread a compare-exchange of a stage, whole warps, at most 1024
  long long threads = (p / 2 + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kShuffleThreads) threads = kShuffleThreads;
  const dim3 grid(1, (unsigned int)(rows < 65535 ? rows : 65535));
  threefry_shuffle_rows_kernel<<<grid, (unsigned int)threads, (size_t)smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), rows, (unsigned int)m,
      (unsigned int)p, (unsigned int)k, rounds, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" int threefry_rows(const void* keys, long long rows, long long m,
                             void* out, int as_float, void* stream) {
  if (rows <= 0 || m <= 0) return (int)cudaSuccess;
  if (m >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bool quad = (m % 4 == 0);
  if (quad && reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long quads = (m + 3) / 4;
  // a warp per row at least; up to kThreads threads across a row's quads
  long long threads = (quads + 31) / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  long long bx = (quads + threads - 1) / threads;
  long long by = rows < 65535 ? rows : 65535;
  // about 16 CTAs per SM in all: the loops stride over the rest
  const long long cap = 132 * 16 * 4;
  if (bx * by > cap) bx = cap / by > 0 ? cap / by : 1;
  const dim3 grid((unsigned int)bx, (unsigned int)by);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quad)
    threefry_rows_kernel<true><<<grid, (unsigned int)threads, 0, s>>>(
        static_cast<const uint32_t*>(keys), rows, (unsigned int)m,
        static_cast<uint32_t*>(out), as_float);
  else
    threefry_rows_kernel<false><<<grid, (unsigned int)threads, 0, s>>>(
        static_cast<const uint32_t*>(keys), rows, (unsigned int)m,
        static_cast<uint32_t*>(out), as_float);
  return (int)cudaGetLastError();
}

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (n < (1ll << 32))
    threefry_fill_kernel<unsigned int><<<(unsigned int)blocks, kThreads, 0,
                                         s>>>(k0, k1, o, (unsigned int)n,
                                              as_float);
  else
    threefry_fill_kernel<unsigned long long>
        <<<(unsigned int)blocks, kThreads, 0, s>>>(
            k0, k1, o, (unsigned long long)n, as_float);
  return (int)cudaGetLastError();
}
