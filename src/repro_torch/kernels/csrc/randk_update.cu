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
// gives it: -0.0 becomes +0.0, and a NaN stays a NaN.  Positions are unique
// (they come from a shuffle); a position outside [0, size) traps, so the
// launch fails: it is never skipped.
//
// Bound: memory.  h is read and h_out written once (8 B per value); at the
// k positions idx and g are read and vals written (12 B per position).
// The Pallas kernel reaches the first part: it rebuilds each (8, 1024)
// tile's mask by k compares against the index list in SMEM, so the dense d
// never touches HBM (and an f32 position compare limits it to 2**24
// values).  The mask rebuild does not carry over; the one pass does.
//
// Design: one pass over h, in tiles of T = 2**tile_log2 values (8192:
// kernels/pack.py RANDK_TILE_LOG2), with no scattered access to h or
// h_out.  The wrapper's plan (pack.randk_plan) picks one of two paths.
//   * Bucketed: a counting sort of the (p, j) pairs by tile p / T, in the
//     scratch the wrapper allocates (layout at randk_update_f32):
//       1. randk_histogram_kernel: hist_ctas CTAs each count a contiguous
//          chunk of idx in shared memory, each position keeping its rank
//          among its CTA's positions of its tile, then add each nonzero
//          count to the tile's global one; that atomic's return is the
//          CTA's offset in the tile's bucket.  Every position is checked
//          here, so a bad one traps before anything is written.  (Few
//          CTAs: k / (4 tiles), at most one an SM, so that these atomics
//          stay near k / 4; a leaf of thousands of positions per tile
//          would otherwise serialise thousands of atomics on each count.)
//       2. randk_scan_kernel: the buckets' starts, an exclusive scan in
//          the shared memory of one CTA;
//       3. randk_scatter_kernel: each pair to start + offset + rank, no
//          atomic, over the whole card.
//     A leaf of more tiles than a CTA's shared memory counts (above 56 Ki
//     tiles: 470M values) takes warp-aggregated global atomics instead
//     (__match_any_sync), for the counts and for the slots.
//   * randk_tile_kernel: persistent CTAs (three an SM, 256 threads) walk
//     the tiles, two tile buffers of shared memory each: the next tile's h
//     arrives by 16-byte cp.async (4-byte where h is not 16-byte aligned)
//     while this one is
//       - patched: each pair of its bucket reads g[p] (tile-local, so a
//         32-byte sector of g serves every selected value in it) and the
//         original h[p] from shared memory, writes vals[j] = v (vals is at
//         most 4 MiB a leaf and stays in L2, where its scattered 4-byte
//         stores merge), the buffer value h[p] + lam * v, and a bit of a
//         shared bitmap;
//       - stored once, with 16-byte stores: h + lam * 0.0 where the bit is
//         clear.
//   * One launch: a leaf whose tiles times k is small (the one-tile leaves,
//     and up to 2**20 idx reads in all: RANDK_SCAN_LIMIT) skips the
//     bucketing: the tile kernel's CTAs (1024 threads there) each read all
//     of idx and patch the positions in their tile.
//   Both paths give the same bits: positions are unique, so the order of
//   the patches does not matter.
// Traffic: 8 B per value (h, h_out), a 32-byte g sector per selected value
// or less, and about 28 B per position (idx twice, the rank written and
// read, the pair written and read, vals); the bucketing's is the design's
// cost, not the function's.  What it costs on the card, kernel by kernel,
// is in PERF.md (chip_smoke.py's [kernels] randk lines).
//
// Plain C interface (loaded with ctypes, no PyTorch headers): the launcher
// returns the first error of its launches (cudaGetLastError) so the Python
// wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // a tile CTA
constexpr int kBinThreads = 1024;   // a histogram or scatter CTA
constexpr int kSms = 132;           // H100 SXM
constexpr int kTileCtasPerSm = 3;   // two 32 KiB tile buffers each
constexpr int kMaxSmemBins = 56 * 1024;  // per-tile counts that fit in a
                                         // CTA's shared memory (224 KiB)
constexpr int kUnroll = 4;          // loads in flight per thread
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ unsigned int lanemask_lt() {
  unsigned int m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ void check_position(int32_t p, long long size) {
  if (p < 0 || (long long)p >= size) __trap();
}

// the chunk of the k positions that each of ``ctas`` CTAs counts: a
// multiple of 16
__device__ __forceinline__ long long chunk_size(long long k, long long ctas) {
  return ((k + ctas - 1) / ctas + 15) / 16 * 16;
}

// Counts of the positions of each tile.
//
// SHARED (a leaf of at most kMaxSmemBins tiles): each CTA takes a
// contiguous chunk of idx and counts it in shared memory, each position
// keeping its rank among its CTA's positions of its tile (rank[j], the
// shared atomic's return); then adds each nonzero count to the global one,
// one atomic per CTA and tile, whose return is the CTA's offset within
// that tile's bucket (off[cta * tiles + t]).  A position's slot in its
// bucket is then start + off + rank, with no atomic in the scatter.
// Otherwise lanes of a warp whose positions fall in one tile add to its
// global count with one atomic (__match_any_sync).
// Every position is checked here, so a bad one traps before anything is
// written.
template <bool SHARED>
__global__ void __launch_bounds__(kBinThreads)
randk_histogram_kernel(const int32_t* __restrict__ idx,
                       int32_t* __restrict__ counts,
                       int32_t* __restrict__ rank, int32_t* __restrict__ off,
                       long long size, long long k, int tile_log2,
                       int tiles) {
  extern __shared__ int32_t bins[];
  const int tid = threadIdx.x;
  if (SHARED) {
    for (int b = tid; b < tiles; b += kBinThreads) bins[b] = 0;
    __syncthreads();
    const long long chunk = chunk_size(k, gridDim.x);
    const long long lo = min(k, blockIdx.x * chunk);
    const long long hi = min(k, lo + chunk);
    const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rank) % 16 == 0;
    const long long quads = vec ? (hi - lo) / 4 : 0;
    const int4* q4 = reinterpret_cast<const int4*>(idx + lo);
    int4* r4 = reinterpret_cast<int4*>(rank + lo);
    for (long long q0 = tid; q0 < quads; q0 += kUnroll * kBinThreads) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q0 + u * kBinThreads < quads) v[u] = q4[q0 + u * kBinThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u * kBinThreads >= quads) break;
        check_position(v[u].x, size);
        check_position(v[u].y, size);
        check_position(v[u].z, size);
        check_position(v[u].w, size);
        r4[q0 + u * kBinThreads] =
            make_int4(atomicAdd(&bins[v[u].x >> tile_log2], 1),
                      atomicAdd(&bins[v[u].y >> tile_log2], 1),
                      atomicAdd(&bins[v[u].z >> tile_log2], 1),
                      atomicAdd(&bins[v[u].w >> tile_log2], 1));
      }
    }
    for (long long j = lo + 4 * quads + tid; j < hi; j += kBinThreads) {
      const int32_t p = idx[j];
      check_position(p, size);
      rank[j] = atomicAdd(&bins[p >> tile_log2], 1);
    }
    __syncthreads();
    // the atomics' returns are independent: kUnroll in flight per thread
    int32_t* mine = off + (long long)blockIdx.x * tiles;
    for (int b0 = tid; b0 < tiles; b0 += kUnroll * kBinThreads) {
      int got[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int b = b0 + u * kBinThreads;
        const int c = b < tiles ? bins[b] : 0;
        got[u] = c ? atomicAdd(&counts[b], c) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (b0 + u * kBinThreads < tiles) mine[b0 + u * kBinThreads] = got[u];
    }
    return;
  }
  const int lane = tid & 31;
  const long long warps = (long long)gridDim.x * (kBinThreads / 32);
  for (long long w = (long long)blockIdx.x * (kBinThreads / 32) + (tid >> 5);
       w * 32 < k; w += warps) {
    const long long j = w * 32 + lane;
    int t = -1;  // past k
    if (j < k) {
      const int32_t p = idx[j];
      check_position(p, size);
      t = p >> tile_log2;
    }
    const unsigned int same = __match_any_sync(kFull, t);
    if (t >= 0 && lane == __ffs(same) - 1) atomicAdd(&counts[t], __popc(same));
  }
}

// Exclusive scan of counts[0, n) in place (the buckets' starts), by one
// CTA of kBinThreads threads, each over a contiguous chunk; a copy into
// ``cursor`` where it is not null.  SHARED: the counts are first copied
// into shared memory (coalesced, 8 loads in flight per thread) and scanned
// there; otherwise (more tiles than shared memory holds) the chunks are
// read in place.
template <bool SHARED>
__global__ void __launch_bounds__(kBinThreads)
randk_scan_kernel(int32_t* __restrict__ counts, int32_t* __restrict__ cursor,
                  int n) {
  extern __shared__ int32_t staged[];
  __shared__ int warp_sums[kBinThreads / 32];
  int32_t* c = SHARED ? staged : counts;
  if (SHARED) {
    for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kBinThreads) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u * kBinThreads < n) v[u] = counts[i0 + u * kBinThreads];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u * kBinThreads < n) staged[i0 + u * kBinThreads] = v[u];
    }
    __syncthreads();
  }
  const int per = (n + kBinThreads - 1) / kBinThreads;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  int mine = 0;
#pragma unroll 8
  for (int i = lo; i < hi; ++i) mine += c[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  // the warps before this one, summed across the lanes
  const int before =
      __reduce_add_sync(kFull, lane < warp ? warp_sums[lane] : 0);
  int run = before + incl - mine;
#pragma unroll 8
  for (int i = lo; i < hi; ++i) {
    const int v = c[i];
    c[i] = run;
    run += v;
  }
  __syncthreads();
  if (SHARED || cursor)
    for (int i = threadIdx.x; i < n; i += kBinThreads) {
      if (SHARED) counts[i] = staged[i];
      if (cursor) cursor[i] = c[i];
    }
}

// Each (p, j) into its tile's bucket, which starts at starts[t].  SHARED:
// at starts[t] + off[c * tiles + t] + rank[j], c the histogram CTA whose
// chunk holds j (``hist_ctas`` of them), with no atomic; otherwise at a
// slot taken from cursor[t] (a copy of the starts) by warp-aggregated
// global atomics.  Either way over the whole card: the pairs' scattered
// stores are what this kernel's time goes to.
template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
randk_scatter_kernel(const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ starts,
                     int32_t* __restrict__ cursor,
                     const int32_t* __restrict__ rank,
                     const int32_t* __restrict__ off,
                     int2* __restrict__ pairs, long long k, int tile_log2,
                     int tiles, int hist_ctas) {
  const int tid = threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (SHARED) {
    const long long chunk = chunk_size(k, hist_ctas);
    for (long long j = (long long)blockIdx.x * kThreads + tid; j < k;
         j += stride) {
      const int32_t p = idx[j];
      const int t = p >> tile_log2;
      pairs[starts[t] + off[j / chunk * tiles + t] + rank[j]] =
          make_int2(p, (int)j);
    }
    return;
  }
  const int lane = tid & 31;
  const long long warps = stride / 32;
  for (long long w = (long long)blockIdx.x * (kThreads / 32) + (tid >> 5);
       w * 32 < k; w += warps) {
    const long long j = w * 32 + lane;
    int32_t p = 0;
    int t = -1;  // past k
    if (j < k) {
      p = idx[j];
      t = p >> tile_log2;
    }
    const unsigned int same = __match_any_sync(kFull, t);
    const int leader = __ffs(same) - 1;
    int slot = 0;
    if (t >= 0 && lane == leader) slot = atomicAdd(&cursor[t], __popc(same));
    slot = __shfl_sync(kFull, slot, leader);
    if (t >= 0)
      pairs[slot + __popc(same & lanemask_lt())] = make_int2(p, (int)j);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the tile kernel's shared memory: two buffers of T values (the tile being
// patched and the next one arriving), then a bitmap of T bits
extern __shared__ __align__(16) float tile_smem[];

// the values of tile t0 / T (n of them) of h into buf, in one copy group
template <int THREADS, bool VEC>
__device__ __forceinline__ void load_tile(float* buf,
                                          const float* __restrict__ h,
                                          long long t0, int n) {
  const int quads = VEC ? n / 4 : 0;
  for (int q = threadIdx.x; q < quads; q += THREADS)
    cp_async16(buf + 4 * q, h + t0 + 4 * q);
  for (int i = 4 * quads + threadIdx.x; i < n; i += THREADS)
    cp_async4(buf + i, h + t0 + i);
  cp_async_commit();
}

// one selected position, local to the tile: vals[j], and the patched value
// and its bit in shared memory (positions are unique: no other thread
// touches this value)
__device__ __forceinline__ void patch(float* sh, unsigned int* bits,
                                      int local, int32_t j, float gp,
                                      float* __restrict__ vals, float scale,
                                      float lam) {
  const float hp = sh[local];
  const float v = __fmul_rn(__fsub_rn(gp, hp), scale);
  vals[j] = v;
  sh[local] = __fadd_rn(hp, __fmul_rn(lam, v));
  atomicOr(&bits[local >> 5], 1u << (local & 31));
}

// h_out of one tile value: the patched value, or h + lam * 0.0
__device__ __forceinline__ float out_value(float v, unsigned int bit,
                                           float zero) {
  return bit ? v : __fadd_rn(v, zero);
}

// Persistent CTAs walk the tiles t = blockIdx.x, + gridDim.x, ...; the copy
// of the next tile's h is in flight while this one is patched and stored.
// BUCKETED: tile t's pairs are pairs[offsets[t], offsets[t + 1]), the last
// ending at k;
// otherwise the CTA reads all of idx for each of its tiles and patches the
// positions in it (THREADS 1024 there, against 256 for a bucket: the whole
// of idx goes through every CTA).  VEC: h and h_out are 16-byte aligned.
template <int THREADS, bool VEC, bool BUCKETED>
__global__ void __launch_bounds__(THREADS)
randk_tile_kernel(const float* __restrict__ g, const float* __restrict__ h,
                  const int32_t* __restrict__ idx,
                  const int2* __restrict__ pairs,
                  const int32_t* __restrict__ offsets,
                  float* __restrict__ vals, float* __restrict__ h_out,
                  long long size, long long k, int tile_log2,
                  long long tiles, float scale, float lam) {
  const int T = 1 << tile_log2;
  unsigned int* bits = reinterpret_cast<unsigned int*>(tile_smem + 2 * T);
  const int tid = threadIdx.x;
  const float zero = __fmul_rn(lam, 0.0f);
  long long t = blockIdx.x;
  for (int i = tid; i < T / 32; i += THREADS) bits[i] = 0u;
  load_tile<THREADS, VEC>(tile_smem, h, t << tile_log2,
                          (int)min((long long)T, size - (t << tile_log2)));
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    float* sh = tile_smem + (it & 1) * T;
    const long long t0 = t << tile_log2;
    const int n = (int)min((long long)T, size - t0);
    const long long next = t + gridDim.x;
    if (next < tiles) {
      load_tile<THREADS, VEC>(
          tile_smem + ((it + 1) & 1) * T, h, next << tile_log2,
          (int)min((long long)T, size - (next << tile_log2)));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile is in shared memory, the bitmap clear

    if (BUCKETED) {
      const long long lo = offsets[t];
      const long long hi = t + 1 < tiles ? offsets[t + 1] : k;
      for (long long i0 = lo + tid; i0 < hi; i0 += kUnroll * THREADS) {
        int2 pr[kUnroll];
        float gv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + u * THREADS < hi) pr[u] = pairs[i0 + u * THREADS];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + u * THREADS < hi) gv[u] = g[pr[u].x];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + u * THREADS < hi)
            patch(sh, bits, (int)(pr[u].x - t0), pr[u].y, gv[u], vals,
                  scale, lam);
      }
    } else {
      for (long long j0 = tid; j0 < k; j0 += kUnroll * THREADS) {
        int32_t p[kUnroll];
        float gv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long j = j0 + u * THREADS;
          p[u] = -1;
          if (j < k) {
            p[u] = idx[j];
            check_position(p[u], size);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (p[u] >= 0 && (p[u] >> tile_log2) == t) gv[u] = g[p[u]];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (p[u] >= 0 && (p[u] >> tile_log2) == t)
            patch(sh, bits, (int)(p[u] - t0), (int32_t)(j0 + u * THREADS),
                  gv[u], vals, scale, lam);
      }
    }
    __syncthreads();

    const int quads = VEC ? n / 4 : 0;
    float4* out4 = reinterpret_cast<float4*>(h_out + t0);
    for (int q = tid; q < quads; q += THREADS) {
      float4 v = reinterpret_cast<const float4*>(sh)[q];
      const unsigned int b = bits[q >> 3] >> ((4 * q) & 31);
      v.x = out_value(v.x, b & 1u, zero);
      v.y = out_value(v.y, b & 2u, zero);
      v.z = out_value(v.z, b & 4u, zero);
      v.w = out_value(v.w, b & 8u, zero);
      out4[q] = v;
    }
    for (int i = 4 * quads + tid; i < n; i += THREADS)
      h_out[t0 + i] = out_value(sh[i], (bits[i >> 5] >> (i & 31)) & 1u,
                                zero);
    __syncthreads();  // every read of this buffer and of the bitmap is done
    for (int i = tid; i < T / 32; i += THREADS) bits[i] = 0u;
  }
}

// CTAs of ``threads`` for one position each, at most 16 per SM (the
// kernels' loops stride over the rest)
unsigned int grid_for(long long k, int threads) {
  const long long most = 16LL * kSms;
  const long long ctas = (k + threads - 1) / threads;
  return (unsigned int)(ctas < 1 ? 1 : ctas > most ? most : ctas);
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

template <bool VEC, bool BUCKETED>
int launch_tiles(const float* g, const float* h, const int32_t* idx,
                 const int2* pairs, const int32_t* offsets, float* vals,
                 float* h_out, long long size, long long k, int tile_log2,
                 long long tiles, float scale, float lam, cudaStream_t st) {
  const size_t smem = ((size_t)2 << tile_log2) * 4 +
                      ((size_t)1 << tile_log2) / 8;
  constexpr int threads = BUCKETED ? kThreads : kBinThreads;
  auto kernel = randk_tile_kernel<threads, VEC, BUCKETED>;
  static size_t opted_in = 0;
  if (const int e = opt_in(kernel, smem, opted_in)) return e;
  // resident CTAs: three of 256 threads an SM, two of 1024
  const long long most = (long long)kSms * (BUCKETED ? kTileCtasPerSm : 2);
  const long long ctas = tiles < most ? tiles : most;
  kernel<<<(unsigned int)ctas, threads, smem, st>>>(
      g, h, idx, pairs, offsets, vals, h_out, size, k, tile_log2, tiles,
      scale, lam);
  return (int)cudaGetLastError();
}

// the counting sort of the (p, j) pairs by tile into pairs, the buckets'
// starts into offsets; the scratch after them (see randk_update_f32)
template <bool SHARED>
int bucket(const int32_t* idx, int32_t* offsets, int32_t* more, int2* pairs,
           long long size, long long k, int tile_log2, int tiles,
           int hist_ctas, cudaStream_t st) {
  int32_t* rank = SHARED ? more : nullptr;
  int32_t* off = SHARED ? more + k : nullptr;
  int32_t* cursor = SHARED ? nullptr : more;
  const size_t smem = SHARED ? (size_t)tiles * 4 : 0;
  static size_t hist_opted = 0, scan_opted = 0;
  if (const int e = opt_in(randk_histogram_kernel<SHARED>, smem, hist_opted))
    return e;
  if (const int e = opt_in(randk_scan_kernel<SHARED>, smem, scan_opted))
    return e;
  const cudaError_t e = cudaMemsetAsync(offsets, 0, tiles * 4LL, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned int hist_grid =
      SHARED ? (unsigned int)hist_ctas : grid_for(k, kBinThreads);
  randk_histogram_kernel<SHARED><<<hist_grid, kBinThreads, smem, st>>>(
      idx, offsets, rank, off, size, k, tile_log2, tiles);
  if (const int err = (int)cudaGetLastError()) return err;
  randk_scan_kernel<SHARED><<<1, kBinThreads, smem, st>>>(offsets, cursor,
                                                          tiles);
  if (const int err = (int)cudaGetLastError()) return err;
  randk_scatter_kernel<SHARED><<<grid_for(k, kThreads), kThreads, 0, st>>>(
      idx, offsets, cursor, rank, off, pairs, k, tile_log2, tiles,
      hist_ctas);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch, when bucketed (int32 words, from an 8-byte-aligned base; see
// kernels/pack.py randk_plan): k int2 pairs, one start per tile, then
//   hist_ctas > 0 (at most kMaxSmemBins tiles): from the next multiple of 4
//     words, k ranks and hist_ctas x tiles offsets;
//   hist_ctas == 0: one cursor per tile.
// tile_log2 in [10, 14].
extern "C" int randk_update_f32(const float* g, const float* h,
                                const int32_t* idx, float* vals,
                                float* h_out, int32_t* scratch,
                                long long size, long long k, int tile_log2,
                                int bucketed, int hist_ctas, float scale,
                                float lam, void* stream) {
  if (size <= 0) return (int)cudaSuccess;
  if (k < 0 || k > size || tile_log2 < 10 || tile_log2 > 14 ||
      size >= (1LL << 31) || hist_ctas < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = ((size - 1) >> tile_log2) + 1;
  const bool vec = reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h_out) % 16 == 0;
  if (!bucketed || k == 0) {
    return vec ? launch_tiles<true, false>(g, h, idx, nullptr, nullptr, vals,
                                           h_out, size, k, tile_log2, tiles,
                                           scale, lam, st)
               : launch_tiles<false, false>(g, h, idx, nullptr, nullptr,
                                            vals, h_out, size, k, tile_log2,
                                            tiles, scale, lam, st);
  }
  if (hist_ctas > 0 && tiles > kMaxSmemBins) return (int)cudaErrorInvalidValue;
  int2* pairs = reinterpret_cast<int2*>(scratch);
  int32_t* offsets = scratch + 2 * k;
  const int err =
      hist_ctas > 0
          ? bucket<true>(idx, offsets, scratch + (2 * k + tiles + 3) / 4 * 4,
                         pairs, size, k, tile_log2, (int)tiles, hist_ctas, st)
          : bucket<false>(idx, offsets, offsets + tiles, pairs, size, k,
                          tile_log2, (int)tiles, 0, st);
  if (err) return err;
  return vec ? launch_tiles<true, true>(g, h, idx, pairs, offsets, vals,
                                        h_out, size, k, tile_log2, tiles,
                                        scale, lam, st)
             : launch_tiles<false, true>(g, h, idx, pairs, offsets, vals,
                                         h_out, size, k, tile_log2, tiles,
                                         scale, lam, st);
}
