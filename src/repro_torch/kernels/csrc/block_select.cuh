// Warp-per-row block-top-k selection, shared by pack_update.cu and
// block_topk.cu.
//
// Port of the selection loop of the Pallas TPU kernels: _select_block_topk
// (src/repro/kernels/pack.py) and _select_mask
// (src/repro/kernels/block_topk.py).  Both keep, per row, the kb largest
// magnitudes by kb rounds of max extraction, ties to the lowest column.
//
// Layout: one warp per row of BLOCK = 32 * PER values; lane l holds columns
// l, l + 32, l + 64, ... (v[j] is column j * 32 + lane) in registers, and a
// per-lane bitmask marks the values already selected.  A round is a
// per-lane scan for the best unselected column, then a warp-shuffle argmax
// on the pair (|v|, -col), after which every lane holds the same winner.
//
// Special values, as in the Pallas kernels:
//   * +inf magnitudes are selected like any other (the kernels' guard is
//     m != -inf, not isfinite);
//   * a NaN anywhere in the row makes the Pallas row max NaN in every round,
//     which matches no column: such a row has no winner in any round.
//
// Cost: a round issues about 96 warp instructions at BLOCK 256 and 216 at
// BLOCK 1024 (SASS of block_topk.cu, CUDA 12.8, sm_90a), so 12 and 6.75
// thread instructions per value and round: at kb = 16 the selection takes
// longer to issue than the row takes to read and write, on an H100.

#pragma once

#include <cuda_runtime.h>

namespace block_select {

// true on every lane when any lane holds a NaN
template <int PER>
__device__ __forceinline__ bool row_has_nan(const float (&v)[PER]) {
  bool lane_nan = false;
#pragma unroll
  for (int j = 0; j < PER; ++j) lane_nan |= isnan(v[j]);
  return __any_sync(0xffffffffu, lane_nan);
}

// One round of max extraction: the column of the row's largest |v| whose
// bit is clear in ``selected``, ties to the lowest column; 32 * PER when
// there is no winner (a NaN row, or every column selected).  Every lane
// returns the same column.
template <int PER>
__device__ __forceinline__ int next_winner(const float (&v)[PER],
                                           unsigned int selected,
                                           bool row_nan, int lane) {
  // this lane's best unselected column; columns ascend with j, so a strict
  // '>' keeps the lowest column among equal magnitudes
  float best = -1.0f;
  int bcol = 32 * PER;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float m = fabsf(v[j]);
    if (!row_nan && !((selected >> j) & 1u) && m > best) {
      best = m;
      bcol = j * 32 + lane;
    }
  }
  // warp argmax on (|v|, -col): every lane ends with the same winner
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oc = __shfl_xor_sync(0xffffffffu, bcol, off);
    if (ob > best || (ob == best && oc < bcol)) {
      best = ob;
      bcol = oc;
    }
  }
  return bcol;
}

// This lane's bitmask of the kb columns that kb rounds select (fewer when
// the row has no winner left).
template <int PER>
__device__ __forceinline__ unsigned int select_mask(const float (&v)[PER],
                                                    int kb, int lane) {
  static_assert(PER >= 1 && PER <= 32, "BLOCK must be in [32, 1024]");
  const bool row_nan = row_has_nan<PER>(v);
  unsigned int selected = 0u;
  for (int r = 0; r < kb; ++r) {
    const int bcol = next_winner<PER>(v, selected, row_nan, lane);
    if (bcol == 32 * PER) break;  // no winner now, none in a later round
    if ((bcol & 31) == lane) selected |= 1u << (bcol >> 5);
  }
  return selected;
}

}  // namespace block_select
