// Fused block-top-k compress-and-pack with the EF-BV control-variate update,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pack.py::_pack_update_kernel (the Pallas TPU
// kernel behind pack_update_pallas, selection in _select_block_topk).
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
// payload entry and marks the value selected in a per-lane bitmask.  The
// dense compressed d never reaches device memory.
//
// Bound: memory.  Each row reads g and h and writes h_out and the payload:
// 3 * 4 * BLOCK + 8 * kb bytes (3,200 B at BLOCK 256, kb 16).  For one
// worker's full qwen2-0.5b gradient (1,929,816 rows) that is 6.18 GB, about
// 1.8 ms at the H100 SXM's 3.35 TB/s.  The selection costs kb * (BLOCK/32 +
// 10) warp instructions per row, below the memory time at kb 16.
//
// Plain C interface (loaded with ctypes, no PyTorch headers): the launcher
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;

template <int BLOCK>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_update_rows(const float* __restrict__ g, const float* __restrict__ h,
                 float* __restrict__ vals, int* __restrict__ idx,
                 float* __restrict__ h_out, long long nb, int kb, float lam) {
  constexpr int PER = BLOCK / 32;
  static_assert(PER >= 1 && PER <= 32, "BLOCK must be in [32, 1024]");
  const long long row =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nb) return;

  const long long base = row * BLOCK;
  float hv[PER];
  float dv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * 32 + lane;
    hv[j] = h[base + c];
    dv[j] = __fsub_rn(g[base + c], hv[j]);
  }

  unsigned int selected = 0u;
  float* vrow = vals + row * kb;
  int* irow = idx + row * kb;
  // a NaN in the row's delta makes the Pallas kernel's row max NaN, which
  // matches no column: no round of such a row has a winner
  bool lane_nan = false;
#pragma unroll
  for (int j = 0; j < PER; ++j) lane_nan |= isnan(dv[j]);
  const bool row_nan = __any_sync(0xffffffffu, lane_nan);
  for (int r = 0; r < kb; ++r) {
    // this lane's best unselected column; columns ascend with j, so a
    // strict '>' keeps the lowest column among equal magnitudes
    float best = -1.0f;
    int bcol = BLOCK;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float m = fabsf(dv[j]);
      if (!row_nan && !((selected >> j) & 1u) && m > best) {
        best = m;
        bcol = j * 32 + lane;
      }
    }
    // warp argmax on (|delta|, -col): every lane ends with the same winner
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bcol, off);
      if (ob > best || (ob == best && oc < bcol)) {
        best = ob;
        bcol = oc;
      }
    }
    if (bcol == BLOCK) {
      // no winner: (0.0, 0), as the Pallas kernel's masked sum and max give
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

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float d = ((selected >> j) & 1u) ? dv[j] : 0.0f;
    h_out[base + j * 32 + lane] = __fadd_rn(hv[j], __fmul_rn(lam, d));
  }
}

template <int BLOCK>
void launch(const float* g, const float* h, float* vals, int* idx,
            float* h_out, long long nb, int kb, float lam,
            cudaStream_t stream) {
  const long long ctas = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  pack_update_rows<BLOCK><<<(unsigned int)ctas, kWarpsPerCta * 32, 0,
                            stream>>>(g, h, vals, idx, h_out, nb, kb, lam);
}

}  // namespace

extern "C" int pack_update_f32(const float* g, const float* h, float* vals,
                               int* idx, float* h_out, long long nb,
                               int block, int kb, float lam, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (kb <= 0 || kb > block) return (int)cudaErrorInvalidValue;
  if ((nb + kWarpsPerCta - 1) / kWarpsPerCta > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: launch<128>(g, h, vals, idx, h_out, nb, kb, lam, s); break;
    case 256: launch<256>(g, h, vals, idx, h_out, nb, kb, lam, s); break;
    case 512: launch<512>(g, h, vals, idx, h_out, nb, kb, lam, s); break;
    case 1024: launch<1024>(g, h, vals, idx, h_out, nb, kb, lam, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
