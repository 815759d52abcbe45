// Fused block-top-k compress-and-pack with the EF-BV control-variate update,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pack.py::pack_update_pallas, both of its
// Pallas TPU bodies (_pack_update_kernel and _pack_update_stream_kernel,
// selection in _select_block_topk).
//
// Per (nb, BLOCK) row, with delta = g - h in f32:
//   vals[r, :] / idx[r, :]  the kb largest |delta| of the row in descending
//                           order, ties to the lowest column (the order of
//                           jax.lax.top_k); vals carry delta's sign, idx is
//                           the block-local column (int32)
//   h_out[r, c]             h + lam * (selected ? delta : 0)
//
// Rounding matches the Pallas kernel bit for bit:
//   * h_out is a multiply then an add, each rounded on its own
//     (__fmul_rn / __fadd_rn stop nvcc from contracting them into an FMA),
//     except at kb = 1: there XLA contracts the Pallas kernel's h update
//     (jitted in interpret mode) into one fused multiply-add, __fmaf_rn
//     (measured against interpret mode; ROADMAP fault l);
//   * the Pallas kernel extracts each value as a masked row SUM, which turns
//     a selected -0.0 into +0.0; __fadd_rn(v, 0.0f) does the same;
//   * a NaN anywhere in a row's delta makes the Pallas kernel's row max NaN
//     in every round, so no column matches it: every round of that row
//     writes (0.0, 0) and selects nothing (h_out = h + lam * 0).
//
// Selection (block_select.cuh): a threshold search replaced the kb rounds of
// warp-shuffle argmax that this kernel ran until then (192 thread
// instructions per value at BLOCK 256, kb 16; 432 at 1024/64).  The kb-th
// largest key is found by bisection with an early exit, the set is every
// key above it plus the lowest columns among the keys equal to it, and the
// payload order comes from compacting the winners in column order into the
// shared-memory slab and ranking each (block_select::pack_payload).
//
// Layouts:
//   * BLOCK <= 1024 (every multiple of 128): one warp per row, 8 rows per
//     CTA; lane l holds columns l, l + 32, ... in registers (BLOCK / 32
//     values), so every load and store of a row is a coalesced 128-byte
//     transaction.
//   * 1024 < block <= 4096 (every multiple of 128): one CTA per row of
//     block / PER threads, PER = 16, 8 or 4 values a thread (the most
//     that leaves whole warps), thread t holding columns t, t + block /
//     PER, ...; the block is a run-time argument and the warps' counts meet
//     in shared memory at each step of the search.
//   * block > 4096 (every multiple of 128, as the TPU kernel takes): the
//     row no longer fits in registers.  One CTA of 1024 threads per row
//     (pack_update_big) reads delta again at each step of the search
//     (block_select::select_cut), from shared memory where the row fits
//     (staged once: up to 57,856 values), recomputed from g and h in device
//     memory above.  Its winners are compacted into kb (value, column)
//     slots of shared memory, or of a device-memory scratch where kb x 8 B
//     does not fit beside the row (264 CTAs then walk the rows, each with
//     its own slots), ranked as pack_payload ranks them, and written to
//     vals and idx at their ranks (no slab, no bulk store).  Right, not
//     fast: PERF.md has its times.
//
// Payload store (replaces _pack_update_stream_kernel, pack.py:91, the
// Pallas variant that stages the payload in VMEM scratch and copies it out
// asynchronously; both Pallas bodies give the same bits): the payload is
// built in a slab of dynamic shared memory, vals then idx (after the slab,
// as much scratch again holds the winners while they are ranked: 16 kb B
// per row in all, 128 KiB per CTA at kb = block = 1024, 64 KiB at kb =
// block = 4096); after a proxy fence and a barrier, one thread hands the
// vals slab and the idx slab to the Tensor Memory Accelerator as two bulk
// stores (cp.async.bulk.global.shared::cta), and the threads then compute
// and store h_out while the payload is copied out; that thread waits for
// the copies to have read the slab before the CTA exits.  A bulk copy needs a
// 16-byte-aligned address and a size that is a multiple of 16:
//   * a warp-per-row CTA's slab is 8 rows x kb x 4 B per array (32 kb B)
//     at byte offset 32 kb blockIdx.x, aligned at any kb, so the wrapper
//     allocates vals and idx with nb rounded up to whole CTAs (from a
//     16-byte-aligned base) and returns the first nb rows; rows past nb
//     take part in the barrier and write (0.0, 0) into the padding;
//   * a CTA-per-row slab is 4 kb B per array, a multiple of 16 only when
//     kb % 4 == 0: there it leaves by bulk stores, and at other kb the
//     threads copy it out with plain stores.
//
// Bound: memory.  Each row reads g and h and writes h_out and the payload:
// 3 * 4 * BLOCK + 8 * kb bytes (3,200 B at BLOCK 256, kb 16).  For one
// worker's full qwen2-0.5b gradient (1,929,816 rows) that is 6.18 GB, about
// 1.84 ms at the H100 SXM's 3.35 TB/s.  At 12 B per value the kernel can
// issue about 120 thread instructions per value before issue, not the
// bytes, sets its time (33.5e12 thread instructions/s).  Issue count (SASS,
// counted by chip_smoke.py with the search's steps replayed on the 14
// full-width leaves): a step is 4.6 instructions per value at BLOCK 256,
// 3.6 at 1024, 5.5 at 4096; with the compaction and the rank loop, 89 per
// value in all at 256/16 and 79 at 1024/64 (the rounds: 192 and 432).
//
// Plain C interface (loaded with ctypes, no PyTorch headers): the launcher
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

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
// CTAs of the big-row kernel when its winners go to device memory: each
// walks rows with its own kb slots of scratch
constexpr int kScratchCtas = 264;

// a CTA's payload slab: vals [rows][kb] f32, then idx [rows][kb] int32
extern __shared__ __align__(16) unsigned char slab_smem[];

// one bulk copy of ``bytes`` from shared to global memory, in the current
// bulk group
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           unsigned int bytes) {
  const unsigned int src =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(gmem), "r"(src), "r"(bytes) : "memory");
}

// make this thread's slab writes visible to the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the slab must outlive the copies' reads of it (the Pallas kernel's
// .wait() on its copies)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// h + lam * d as the Pallas kernel rounds it in interpret mode
__device__ __forceinline__ float h_update(float h, float d, float lam,
                                          int kb) {
  return kb == 1 ? __fmaf_rn(lam, d, h) : __fadd_rn(h, __fmul_rn(lam, d));
}

template <int BLOCK>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_update_rows(const float* __restrict__ g, const float* __restrict__ h,
                 float* __restrict__ vals, int* __restrict__ idx,
                 float* __restrict__ h_out, long long nb, int kb, float lam) {
  constexpr int PER = BLOCK / 32;
  static_assert(PER >= 1 && PER <= 32, "BLOCK must be in [32, 1024]");
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerCta + warp;
  const int lane = threadIdx.x & 31;
  // rows past nb take part in the barrier and store no h_out
  const bool live = row < nb;

  float* vslab = reinterpret_cast<float*>(slab_smem);
  float* vrow = vslab + warp * kb;
  int* irow = reinterpret_cast<int*>(vslab + kWarpsPerCta * kb) + warp * kb;
  // the row's scratch, after both slabs: its winners as (value, column)
  float2* winners =
      reinterpret_cast<float2*>(vslab + 2 * kWarpsPerCta * kb) + warp * kb;

  const long long base = row * BLOCK;
  float hv[PER];
  float dv[PER];
  unsigned int selected = 0u;
  if (live) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = j * 32 + lane;
      hv[j] = h[base + c];
      dv[j] = __fsub_rn(g[base + c], hv[j]);
    }
    block_select::WarpRow r{lane};
    selected = block_select::select_mask<PER>(dv, kb, BLOCK, r);
    block_select::pack_payload<PER>(dv, selected, kb, r, vrow, irow,
                                    winners);
  } else {
    // a row past nb: its slab row lands in the padding
    for (int p = lane; p < kb; p += 32) {
      vrow[p] = 0.0f;
      irow[p] = 0;
    }
  }

  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int bytes = kWarpsPerCta * kb * 4u;
    const long long off = (long long)blockIdx.x * kWarpsPerCta * kb;
    bulk_store(vals + off, slab_smem, bytes);
    bulk_store(idx + off, slab_smem + bytes, bytes);
    bulk_commit();
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float d = ((selected >> j) & 1u) ? dv[j] : 0.0f;
      h_out[base + j * 32 + lane] = h_update(hv[j], d, lam, kb);
    }
  }

  if (threadIdx.x == 0) bulk_wait_read();
}

// one row of ``block`` values per CTA of block / PER threads
template <int PER>
__global__ void __launch_bounds__(kMaxBlock / PER)
pack_update_cta(const float* __restrict__ g, const float* __restrict__ h,
                float* __restrict__ vals, int* __restrict__ idx,
                float* __restrict__ h_out, int block, int kb, float lam) {
  __shared__ int sums[64];
  const int t = threadIdx.x;
  const int threads = blockDim.x;
  block_select::CtaRow r{sums, t >> 5, t & 31, threads >> 5, 0};
  const long long row = blockIdx.x;
  const long long base = row * block;
  // the slab, vals then idx, then the scratch of the winners as (value,
  // column)
  float* vrow = reinterpret_cast<float*>(slab_smem);
  int* irow = reinterpret_cast<int*>(vrow + kb);
  float2* winners = reinterpret_cast<float2*>(vrow + 2 * kb);

  float hv[PER];
  float dv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * threads + t;
    hv[j] = h[base + c];
    dv[j] = __fsub_rn(g[base + c], hv[j]);
  }
  const unsigned int selected =
      block_select::select_mask<PER>(dv, kb, block, r);
  block_select::pack_payload<PER>(dv, selected, kb, r, vrow, irow,
                                  winners);

  const bool bulk = kb % 4 == 0;
  if (bulk) fence_proxy_async();
  __syncthreads();
  if (bulk) {
    if (t == 0) {
      bulk_store(vals + row * kb, vrow, kb * 4u);
      bulk_store(idx + row * kb, irow, kb * 4u);
      bulk_commit();
    }
  } else {
    for (int p = t; p < kb; p += threads) {
      vals[row * kb + p] = vrow[p];
      idx[row * kb + p] = irow[p];
    }
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float d = ((selected >> j) & 1u) ? dv[j] : 0.0f;
    h_out[base + j * threads + t] = h_update(hv[j], d, lam, kb);
  }

  if (bulk && t == 0) bulk_wait_read();
}

// Rows above kMaxBlock: one CTA of kBigThreads per row (or, with winners in
// device memory, kScratchCtas CTAs walking the rows).  The row's delta is
// read again at each step of the search (block_select::select_cut) from
// shared memory (ROW_SMEM: staged once) or recomputed from g and h in
// device memory.  The winners are compacted (one shared atomic per warp;
// their order there does not matter) into kb (value, column) slots of
// shared memory, or of ``scratch`` where kb x 8 B does not fit, and each is
// ranked as in block_select::pack_payload; the payload goes straight to
// vals and idx at its rank, no slab.
struct GlobalDelta {
  const float* g;
  const float* h;
  __device__ __forceinline__ float operator()(int c) const {
    return __fsub_rn(g[c], h[c]);
  }
};

struct SharedRow {
  const float* s;
  __device__ __forceinline__ float operator()(int c) const { return s[c]; }
};

template <bool ROW_SMEM>
__global__ void __launch_bounds__(kBigThreads)
pack_update_big(const float* __restrict__ g, const float* __restrict__ h,
                float* __restrict__ vals, int* __restrict__ idx,
                float* __restrict__ h_out, long long nb, int block, int kb,
                float lam, float2* __restrict__ scratch) {
  __shared__ int sums[64];
  __shared__ int count;
  const int t = threadIdx.x, lane = t & 31;
  block_select::CtaRow r{sums, t >> 5, lane, kBigThreads / 32, 0};
  float* rowv = reinterpret_cast<float*>(slab_smem);
  float2* winners =
      scratch ? scratch + (long long)blockIdx.x * kb
              : reinterpret_cast<float2*>(rowv + (ROW_SMEM ? block : 0));
  for (long long row = blockIdx.x; row < nb; row += gridDim.x) {
    const long long base = row * block;
    const GlobalDelta src{g + base, h + base};
    block_select::Cut cut;
    if (ROW_SMEM) {
      for (int c = t; c < block; c += kBigThreads) rowv[c] = src(c);
      __syncthreads();
      cut = block_select::select_cut(SharedRow{rowv}, kb, block, r);
    } else {
      cut = block_select::select_cut(src, kb, block, r);
    }
    if (t == 0) count = 0;
    __syncthreads();
    // block % 128 == 0: a warp's 32 columns are all in the row or all past
    for (int c = t; c < block; c += kBigThreads) {
      const float v = ROW_SMEM ? rowv[c] : src(c);
      const bool keep = cut.keep(fabsf(v), c);
      const unsigned int b = __ballot_sync(block_select::kFull, keep);
      int at = 0;
      if (lane == 0 && b) at = atomicAdd(&count, __popc(b));
      at = __shfl_sync(block_select::kFull, at, 0);
      if (keep)
        winners[at + __popc(b & block_select::lanemask_lt())] =
            make_float2(v, __int_as_float(c));
      h_out[base + c] = h_update(h[base + c], keep ? v : 0.0f, lam, kb);
    }
    __syncthreads();
    const int n = count;
    for (int s = t; s < kb; s += kBigThreads) {
      const long long out = row * kb;
      if (s < n) {
        const float2 mine = winners[s];
        const float m = fabsf(mine.x);
        const int col = __float_as_int(mine.y);
        int rank = 0;
        for (int q = 0; q < n; ++q) {
          const float2 o = winners[q];
          const float a = fabsf(o.x);
          rank += (a > m) | ((a == m) & (__float_as_int(o.y) < col));
        }
        vals[out + rank] = __fadd_rn(mine.x, 0.0f);
        idx[out + rank] = col;
      } else {
        vals[out + s] = 0.0f;
        idx[out + s] = 0;
      }
    }
    __syncthreads();  // the row's shared memory and winners are free again
  }
}

// above 48 KiB of shared memory, static included, a kernel must opt in to
// its dynamic shared memory: each launcher opts in to the most it has asked
// for so far (from 0, so the static shared memory never tips it over
// unseen)
template <typename K>
int opt_in(K kernel, size_t smem, size_t& opted_in) {
  if (smem <= opted_in) return (int)cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) opted_in = smem;
  return (int)e;
}

template <int BLOCK>
int launch(const float* g, const float* h, float* vals, int* idx,
           float* h_out, long long nb, int kb, float lam,
           cudaStream_t stream) {
  const long long ctas = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  // slab and scratch: 4 arrays of kWarpsPerCta x kb
  const size_t smem = (size_t)kWarpsPerCta * kb * 16;
  static size_t opted_in = 0;
  if (const int e = opt_in(pack_update_rows<BLOCK>, smem, opted_in)) return e;
  pack_update_rows<BLOCK><<<(unsigned int)ctas, kWarpsPerCta * 32, smem,
                            stream>>>(g, h, vals, idx, h_out, nb, kb, lam);
  return (int)cudaGetLastError();
}

template <int PER>
int launch_cta(const float* g, const float* h, float* vals, int* idx,
               float* h_out, long long nb, int block, int kb, float lam,
               cudaStream_t stream) {
  // slab and scratch: 4 arrays of kb (64 KiB at kb = 4096)
  const size_t smem = (size_t)kb * 16;
  static size_t opted_in = 0;
  if (const int e = opt_in(pack_update_cta<PER>, smem, opted_in)) return e;
  pack_update_cta<PER><<<(unsigned int)nb, block / PER, smem, stream>>>(
      g, h, vals, idx, h_out, block, kb, lam);
  return (int)cudaGetLastError();
}

// the device-memory scratch (bytes) the pack needs for its winners: none
// up to kMaxBlock, nor where the row (if it fits) and kb slots fit in
// shared memory
long long big_scratch_bytes(long long nb, int block, int kb) {
  if (block <= kMaxBlock) return 0;
  const long long row = (long long)block * 4 <= kSmemMax ? block * 4LL : 0;
  if (row + kb * 8LL <= kSmemMax) return 0;
  return (nb < kScratchCtas ? nb : kScratchCtas) * kb * 8LL;
}

int launch_big(const float* g, const float* h, float* vals, int* idx,
               float* h_out, long long nb, int block, int kb, float lam,
               float2* scratch, cudaStream_t stream) {
  const bool row_smem = (long long)block * 4 <= kSmemMax;
  const bool in_smem = big_scratch_bytes(nb, block, kb) == 0;
  if (!in_smem && !scratch) return (int)cudaErrorInvalidValue;
  const size_t smem = (row_smem ? (size_t)block * 4 : 0) +
                      (in_smem ? (size_t)kb * 8 : 0);
  const unsigned int ctas =
      (unsigned int)(in_smem || nb < kScratchCtas ? nb : kScratchCtas);
  float2* slots = in_smem ? nullptr : scratch;
  if (row_smem) {
    static size_t opted_in = 0;
    if (const int e = opt_in(pack_update_big<true>, smem, opted_in)) return e;
    pack_update_big<true><<<ctas, kBigThreads, smem, stream>>>(
        g, h, vals, idx, h_out, nb, block, kb, lam, slots);
  } else {
    static size_t opted_in = 0;
    if (const int e = opt_in(pack_update_big<false>, smem, opted_in))
      return e;
    pack_update_big<false><<<ctas, kBigThreads, smem, stream>>>(
        g, h, vals, idx, h_out, nb, block, kb, lam, slots);
  }
  return (int)cudaGetLastError();
}

#define WARP_BLOCKS(F) \
  F(128) F(256) F(384) F(512) F(640) F(768) F(896) F(1024)

}  // namespace

// bytes of device memory pack_update_f32 needs as its scratch (0: none)
extern "C" long long pack_update_scratch_bytes(long long nb, int block,
                                               int kb) {
  return nb > 0 ? big_scratch_bytes(nb, block, kb) : 0;
}

// vals and idx hold nb rounded up to whole CTAs of 8 rows and start 16-byte
// aligned; block is any multiple of 128; scratch holds
// pack_update_scratch_bytes(nb, block, kb) bytes, 8-byte aligned (null
// when that is 0)
extern "C" int pack_update_f32(const float* g, const float* h, float* vals,
                               int* idx, float* h_out, void* scratch,
                               long long nb, int block, int kb, float lam,
                               void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (kb <= 0 || kb > block || block % 128)
    return (int)cudaErrorInvalidValue;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
#define CASE(B) \
  case B:       \
    return launch<B>(g, h, vals, idx, h_out, nb, kb, lam, s);
    WARP_BLOCKS(CASE)
#undef CASE
    default:
      if (block > kMaxBlock)
        return launch_big(g, h, vals, idx, h_out, nb, block, kb, lam,
                          static_cast<float2*>(scratch), s);
      // the most values a thread that leave whole warps
      if (block % 512 == 0)
        return launch_cta<16>(g, h, vals, idx, h_out, nb, block, kb, lam, s);
      if (block % 256 == 0)
        return launch_cta<8>(g, h, vals, idx, h_out, nb, block, kb, lam, s);
      return launch_cta<4>(g, h, vals, idx, h_out, nb, block, kb, lam, s);
  }
}
