// Block-top-k selection by a threshold search, shared by pack_update.cu and
// block_topk.cu.
//
// Port of the selection of the Pallas TPU kernels: _select_block_topk
// (src/repro/kernels/pack.py) and _select_mask
// (src/repro/kernels/block_topk.py).  Both keep, per row, the kb largest
// magnitudes, ties to the lowest column; a row holding a NaN keeps nothing
// (its Pallas row max is NaN in every round and matches no column); +inf is
// kept like any other magnitude (the Pallas guard is m != -inf); -0.0 ties
// with +0.0 by column.  The Pallas kernels get there by kb rounds of max
// extraction; so did this file until it was rewritten (kb rounds of a
// warp-shuffle argmax: 192 thread instructions per value at BLOCK 256, kb 16,
// and 432 at 1024/64, more than the bytes of any of the three kernels).
//
// What replaced the rounds: a threshold search on the magnitudes' keys.
//   1. Key: the bits of |x| in f32, __float_as_uint(x) & 0x7fffffff.  On
//      every non-NaN value it orders as |x| compares, +inf included, so the
//      kernels compare |x| as floats (fabsf costs nothing: it is an operand
//      modifier of FSETP, and no key registers are needed).
//   2. Search: T, the kb-th largest key, by bisection over its 31 bits.  A
//      step counts the keys >= a candidate: a compare and an add per value a
//      thread holds, one __reduce_add_sync (redux.sync) for the warp, and,
//      for a row held by a CTA, the warps' counts summed through shared
//      memory.
//   3. Early exit: the search stops as soon as exactly kb keys are >= the
//      candidate; the set is then decided (no key equal to T is left out).
//      The count is the row's, so the exit is uniform across the row's
//      threads.
//   4. Set: every key > T, then the kb - count(> T) lowest columns among
//      the keys == T, by a ballot prefix count in column order.
// Every step and the tie split are exact integer counts, so the set is the
// same as the rounds' (held bitwise on the card and against the Pallas
// kernels in tests/test_torch_pack.py).
//
// Cost (thread instructions, SASS of CUDA 12.8 for sm_90a): a step is a
// compare and a select or add per value a thread holds plus about 13 for
// the reduction and the exit test: 36 a lane at BLOCK 256 (4.5 per value),
// 112 at 1024 (3.5), 78 a thread at 4096 (16 values, 4.9 with the barrier).
// At most 31 steps; on the full-width gaussian leaves the early exit comes
// after 12.8-16.4 steps on average (256/16 to 4096/64), about 45-80
// instructions per value in all, against the 192 (256/16) and 432
// (1024/64) of the rounds.  chip_smoke.py reads the step loop from the
// SASS and replays the steps on the full-width leaves.
//
// Layouts (a Row type): WarpRow, one warp per row with lane l holding
// columns j * 32 + l (BLOCK up to 1024, the row in registers); CtaRow, one
// CTA per row of 32 W threads, thread t holding columns j * 32 W + t (blocks
// from 1152 to 4096: PER = 16, 8 or 4 values a thread, the most that gives
// whole warps, so W = block / (32 PER)).  Above 4096 a CtaRow of 1024
// threads reads the row from memory at each step (select_cut, below).

#pragma once

#include <cuda_runtime.h>

namespace block_select {

constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ unsigned int lanemask_lt() {
  unsigned int m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// One warp per row.
struct WarpRow {
  int lane;
  __device__ __forceinline__ int col(int j) const { return j * 32 + lane; }
  __device__ __forceinline__ int threads() const { return 32; }
  __device__ __forceinline__ int thread() const { return lane; }
  __device__ __forceinline__ int sum(int v) {
    return __reduce_add_sync(kFull, v);
  }
  // exclusive count of ``flag`` over the threads before this one, and the
  // row's total
  __device__ __forceinline__ int prefix(bool flag, int& total) {
    const unsigned int b = __ballot_sync(kFull, flag);
    total = __popc(b);
    return __popc(b & lanemask_lt());
  }
  // exclusive sum of ``v`` over the threads before this one, and the
  // row's total
  __device__ __forceinline__ int exclusive(int v, int& total) {
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    total = __shfl_sync(kFull, incl, 31);
    return incl - v;
  }
  __device__ __forceinline__ void sync() { __syncwarp(); }
};

// One CTA of ``nwarps`` whole warps per row.  ``scratch`` is 64 ints of
// shared memory, used as two buffers in turn: a call writes one after the
// barrier that ended every read of it two calls before, so each call needs
// one barrier.
struct CtaRow {
  int* scratch;
  int warp, lane, nwarps, buf;
  __device__ __forceinline__ int col(int j) const {
    return j * nwarps * 32 + warp * 32 + lane;
  }
  __device__ __forceinline__ int threads() const { return nwarps * 32; }
  __device__ __forceinline__ int thread() const { return warp * 32 + lane; }
  __device__ __forceinline__ int* next() {
    int* s = scratch + 32 * buf;
    buf ^= 1;
    return s;
  }
  __device__ __forceinline__ int sum(int v) {
    v = __reduce_add_sync(kFull, v);
    int* s = next();
    if (lane == 0) s[warp] = v;
    __syncthreads();
    return __reduce_add_sync(kFull, lane < nwarps ? s[lane] : 0);
  }
  __device__ __forceinline__ int prefix(bool flag, int& total) {
    const unsigned int b = __ballot_sync(kFull, flag);
    int* s = next();
    if (lane == 0) s[warp] = __popc(b);
    __syncthreads();
    // inclusive scan of the warps' counts across the lanes
    const int c = lane < nwarps ? s[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    total = __shfl_sync(kFull, incl, 31);
    return __shfl_sync(kFull, incl - c, warp) + __popc(b & lanemask_lt());
  }
  __device__ __forceinline__ int exclusive(int v, int& total) {
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    int* s = next();
    if (lane == 31) s[warp] = incl;
    __syncthreads();
    const int c = lane < nwarps ? s[lane] : 0;
    int wincl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, wincl, off);
      if (lane >= off) wincl += o;
    }
    total = __shfl_sync(kFull, wincl, 31);
    return __shfl_sync(kFull, wincl - c, warp) + incl - v;
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
};

// This thread's bitmask of selected values (bit j: column row.col(j)) of a
// row of ``block`` values, PER per thread.  Every thread of the row must
// call it (it synchronises them).
template <int PER, class Row>
__device__ __forceinline__ unsigned int select_mask(const float (&v)[PER],
                                                    int kb, int block,
                                                    Row& row) {
  static_assert(PER >= 1 && PER <= 32, "PER must be in [1, 32]");
  int nan = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) nan |= isnan(v[j]);
  if (row.sum(nan)) return 0u;  // a NaN row keeps nothing
  const unsigned int all = PER == 32 ? kFull : (1u << PER) - 1u;
  if (kb >= block) return all;  // every key >= 0: the search is done

  unsigned int t = 0u;  // count(keys >= t) >= kb throughout
  int gt = 0;           // count(keys > t) when the search runs to bit 0
  bool exact = false;
#pragma unroll 1
  for (int b = 30; b >= 0; --b) {
    const unsigned int cand = t | (1u << b);
    const float cf = __uint_as_float(cand);  // a NaN above +inf: counts 0
    int c = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) c += fabsf(v[j]) >= cf;
    c = row.sum(c);
    if (c >= kb) {
      t = cand;
      if (c == kb) {
        exact = true;
        break;
      }
    } else {
      // the last candidate that fails is t + 1 (t's lowest zero bit)
      gt = c;
    }
  }
  const float tf = __uint_as_float(t);
  unsigned int sel = 0u;
  if (exact) {
#pragma unroll
    for (int j = 0; j < PER; ++j) sel |= (fabsf(v[j]) >= tf ? 1u : 0u) << j;
    return sel;
  }
  // kb - gt of the keys equal to t, the lowest columns first
  int need = kb - gt;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float m = fabsf(v[j]);
    const bool eq = m == tf;
    int total;
    const int before = row.prefix(eq, total);
    if (m > tf || (eq && before < need)) sel |= 1u << j;
    need -= total;
  }
  return sel;
}

// The pack's payload: the row's selected values and their columns, in
// jax.lax.top_k's order (|v| descending, then column ascending), into the
// row's kb slots of shared memory (vrow, irow); a row with fewer winners (a
// NaN row has none) sends (0.0, 0) in the rest.  Values go through
// __fadd_rn(v, 0.0f): a selected -0.0 travels as +0.0, as the Pallas
// kernel's masked row sum gives it.
//
// The winners are first compacted into the row's kb slots of scratch shared
// memory (``winners``: (value, column) pairs), each thread's after those of
// the threads before it (one exclusive sum of the threads' counts); then
// each thread ranks the scratch slots p = thread, thread + threads, ...:
// the winners ahead of p are those with a larger |v|, plus those with an
// equal |v| and a lower column; and writes slot p's value and column to
// the payload at its rank.  A rank loop is kb iterations of a broadcast
// 8-byte shared-memory load, three compares and an add (3.75 instructions
// an iteration in the SASS, the loop unrolled by 4); a thread ranks
// ceil(kb / threads) slots: at kb 16, block 256, 60 instructions a lane,
// fewer than a warp's bitonic sort of 64-bit (key, column) pairs issues
// (15 exchange stages of two shuffles, two compares and two selects each).
// The same loop serves every kb up to the block.
template <int PER, class Row>
__device__ __forceinline__ void pack_payload(const float (&v)[PER],
                                             unsigned int sel, int kb,
                                             Row& row, float* vrow, int* irow,
                                             float2* winners) {
  int n;
  int p = row.exclusive(__popc(sel), n);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if ((sel >> j) & 1u) {
      winners[p] = make_float2(v[j], __int_as_float(row.col(j)));
      ++p;
    }
  }
  row.sync();
  for (int s = row.thread(); s < kb; s += row.threads()) {
    if (s < n) {
      const float2 mine = winners[s];
      const float m = fabsf(mine.x);
      const int col = __float_as_int(mine.y);
      int r = 0;
      for (int q = 0; q < n; ++q) {
        const float2 o = winners[q];
        const float a = fabsf(o.x);
        r += (a > m) | ((a == m) & (__float_as_int(o.y) < col));
      }
      vrow[r] = __fadd_rn(mine.x, 0.0f);
      irow[r] = col;
    } else {
      vrow[s] = 0.0f;
      irow[s] = 0;
    }
  }
}

// Rows above 4096 values (BIG rows): one CTA of 1024 threads per row, the
// row too large for the threads' registers.  The values are read again at
// every step of the search from ``src`` (src(c) is column c as f32: shared
// memory where the row fits, else recomputed from device memory), thread t
// reading columns j * 1024 + t.  The search, the early exit and the tie
// rule are select_mask's; the set comes back as a Cut, three scalars:
// keep |v| > T, and |v| == T at a column <= cut (every such column when
// the keys >= T are exactly kb).  A NaN row keeps nothing (T is a NaN,
// which no |v| compares to); kb >= block keeps every value (T = 0, exact).
struct Cut {
  float t;
  int exact;
  int cut;
  __device__ __forceinline__ bool keep(float m, int col) const {
    return m > t || (m == t && (exact || col <= cut));
  }
};

template <class Src>
__device__ Cut select_cut(const Src& src, int kb, int block, CtaRow& row) {
  const int threads = row.threads();
  const int per = (block + threads - 1) / threads;
  const int me = row.thread();
  int nan = 0;
  for (int j = 0; j < per; ++j) {
    const int c = j * threads + me;
    if (c < block) nan |= isnan(src(c));
  }
  if (row.sum(nan)) return Cut{__uint_as_float(0x7fffffffu), 0, -1};
  if (kb >= block) return Cut{0.0f, 1, -1};

  unsigned int t = 0u;  // count(keys >= t) >= kb throughout
  int gt = 0;           // count(keys > t) when the search runs to bit 0
#pragma unroll 1
  for (int b = 30; b >= 0; --b) {
    const unsigned int cand = t | (1u << b);
    const float cf = __uint_as_float(cand);
    int c = 0;
    for (int j = 0; j < per; ++j) {
      const int col = j * threads + me;
      if (col < block) c += fabsf(src(col)) >= cf;
    }
    c = row.sum(c);
    if (c >= kb) {
      t = cand;
      if (c == kb) return Cut{cf, 1, -1};
    } else {
      gt = c;
    }
  }
  // kb - gt of the keys equal to t, the lowest columns first: the column
  // of the (kb - gt)-th such key, found chunk by chunk in column order
  const float tf = __uint_as_float(t);
  int need = kb - gt;
  for (int j = 0; j < per; ++j) {
    const int col = j * threads + me;
    const bool eq = col < block && fabsf(src(col)) == tf;
    int total;
    const int before = row.prefix(eq, total);
    if (total >= need)  // the same for every thread of the row
      return Cut{tf, 0, row.sum(eq && before == need - 1 ? col + 1 : 0) - 1};
    need -= total;
  }
  return Cut{tf, 0, block};  // not reached: the keys == t are >= kb - gt
}

}  // namespace block_select
