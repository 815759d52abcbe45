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
//     (__fmul_rn / __fadd_rn stop nvcc from contracting them into an FMA);
//   * the Pallas kernel extracts each value as a masked row SUM, which turns
//     a selected -0.0 into +0.0; __fadd_rn(v, 0.0f) does the same;
//   * a NaN anywhere in a row's delta makes the Pallas kernel's row max NaN
//     in every round, so no column matches it: every round of that row
//     writes (0.0, 0) and selects nothing (h_out = h + lam * 0).
//
// Layout: one warp per row; lane l holds columns l, l + 32, l + 64, ... in
// registers (BLOCK / 32 values), so every load and store of a row is a
// coalesced 128-byte transaction.  Selection runs kb rounds of a warp-shuffle
// argmax on the pair (|delta|, -col); the winning lane writes that round's
// payload entry and marks the value selected in a per-lane bitmask (the
// selection lives in block_select.cuh, shared with block_topk.cu).  The
// dense compressed d never reaches device memory.
//
// Bound: memory.  Each row reads g and h and writes h_out and the payload:
// 3 * 4 * BLOCK + 8 * kb bytes (3,200 B at BLOCK 256, kb 16).  For one
// worker's full qwen2-0.5b gradient (1,929,816 rows) that is 6.18 GB, about
// 1.8 ms at the H100 SXM's 3.35 TB/s.  The selection (block_select.cuh)
// issues 12 thread instructions per value and round at BLOCK 256: 2.83 ms
// over that gradient at kb 16, above the memory time.
//
// Payload store (replaces _pack_update_stream_kernel, pack.py:91, the
// Pallas variant that stages the payload in VMEM scratch and copies it out
// asynchronously; both Pallas bodies give the same bits): each warp writes
// its row's kb (value, index) pairs into dynamic shared memory, a slab of
// 8 rows x kb x 8 B per CTA (1 KiB at kb 16, 64 KiB at kb = block = 1024).
// After a proxy fence and a barrier, one thread hands the vals slab and the
// idx slab to the Tensor Memory Accelerator as two bulk stores
// (cp.async.bulk.global.shared::cta), and the warps then compute and store
// h_out while the payload is copied out; that thread waits for the copies
// to have read the slab before the CTA exits.  A bulk copy needs a
// 16-byte-aligned address and a size that is a multiple of 16: a CTA's slab
// is 32 * kb bytes at byte offset 32 * kb * blockIdx.x, so the wrapper
// allocates vals and idx with nb rounded up to whole CTAs (from a
// 16-byte-aligned base) and returns the first nb rows; rows past nb take
// part in the barrier and write (0.0, 0) into the padding.
//
// Plain C interface (loaded with ctypes, no PyTorch headers): the launcher
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_select.cuh"

namespace {

constexpr int kWarpsPerCta = 8;

// a CTA's payload slab: vals [kWarpsPerCta][kb] f32, then
// idx [kWarpsPerCta][kb] int32
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

    // a NaN in the row's delta makes the Pallas kernel's row max NaN, which
    // matches no column: no round of such a row has a winner
    const bool row_nan = block_select::row_has_nan<PER>(dv);
    for (int r = 0; r < kb; ++r) {
      const int bcol =
          block_select::next_winner<PER>(dv, selected, row_nan, lane);
      if (bcol == BLOCK) {
        // no winner: (0.0, 0), as the Pallas kernel's masked sum and max
        // give
        if (lane == 0) {
          vrow[r] = 0.0f;
          irow[r] = 0;
        }
      } else if ((bcol & 31) == lane) {
        const int jw = bcol >> 5;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (j == jw) {
            selected |= 1u << j;
            vrow[r] = __fadd_rn(dv[j], 0.0f);
            irow[r] = bcol;
          }
        }
      }
    }
  } else {
    // a row past nb: its slab row lands in the padding
    for (int r = lane; r < kb; r += 32) {
      vrow[r] = 0.0f;
      irow[r] = 0;
    }
  }

  // make this thread's slab writes visible to the async proxy, then one
  // thread starts the CTA's two bulk stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int bytes = kWarpsPerCta * kb * 4u;
    const long long off = (long long)blockIdx.x * kWarpsPerCta * kb;
    bulk_store(vals + off, slab_smem, bytes);
    bulk_store(idx + off, slab_smem + bytes, bytes);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float d = ((selected >> j) & 1u) ? dv[j] : 0.0f;
      h_out[base + j * 32 + lane] = __fadd_rn(hv[j], __fmul_rn(lam, d));
    }
  }

  if (threadIdx.x == 0) {
    // the slab must outlive the copies' reads of it (the Pallas kernel's
    // .wait() on its copies)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int BLOCK>
int launch(const float* g, const float* h, float* vals, int* idx,
           float* h_out, long long nb, int kb, float lam,
           cudaStream_t stream) {
  const long long ctas = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  const size_t smem = (size_t)kWarpsPerCta * kb * 8;
  // above 48 KiB a kernel must opt in to its dynamic shared memory
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_update_rows<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  pack_update_rows<BLOCK><<<(unsigned int)ctas, kWarpsPerCta * 32, smem,
                            stream>>>(g, h, vals, idx, h_out, nb, kb, lam);
  return (int)cudaGetLastError();
}

}  // namespace

// vals and idx hold nb rounded up to whole CTAs (a multiple of 8 rows) and
// start 16-byte aligned
extern "C" int pack_update_f32(const float* g, const float* h, float* vals,
                               int* idx, float* h_out, long long nb,
                               int block, int kb, float lam, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (kb <= 0 || kb > block) return (int)cudaErrorInvalidValue;
  if ((nb + kWarpsPerCta - 1) / kWarpsPerCta > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128:
      return launch<128>(g, h, vals, idx, h_out, nb, kb, lam, s);
    case 256:
      return launch<256>(g, h, vals, idx, h_out, nb, kb, lam, s);
    case 512:
      return launch<512>(g, h, vals, idx, h_out, nb, kb, lam, s);
    case 1024:
      return launch<1024>(g, h, vals, idx, h_out, nb, kb, lam, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
