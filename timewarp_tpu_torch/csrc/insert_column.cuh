// The insertion walk of K1 (mailbox_insert.cu), as the reference's
// _build_kernel walks its "drel" mode. The row walk is K1's alone: K3
// (sample_insert.cu) walks a tile at a time (tile_insert.cuh), which
// shares only Entry and warp_sum from here.
//
// One thread owns node column d and walks its K mailbox rows, so each
// plane access is a coalesced 128-byte warp transaction. Node d's new
// messages are batch entries st .. st + c - 1. Commutative inbox (base <
// 0): the r-th message fills d's r-th empty slot (mb_rel == INT32_MAX),
// the hole rank being a running count down the rows. Ordered inbox (base
// = the node's kept rows): it fills row base + r. Every other row is
// copied through. entry(j) gives batch entry j's epoch-relative deliver
// time and sender; it is called once for each message that finds a row,
// in rank order. mb_src/o_src are null when the inbox carries no src.

#pragma once

#include <climits>
#include <cstdint>

namespace tw {

struct Entry {
  int32_t drel;
  int32_t src;
};

// Returns the room: the rows the batch could take (K - base, or the
// holes). Messages past it are the overflow.
template <class EntryFn>
__device__ __forceinline__ int insert_column(
    int d, int n, int K, int P, int S, int st, int c, int base,
    EntryFn&& entry, const int32_t* __restrict__ pay,
    const int32_t* __restrict__ mb_rel, const int32_t* __restrict__ mb_src,
    const int32_t* __restrict__ mb_pay, int32_t* __restrict__ o_rel,
    int32_t* __restrict__ o_src, int32_t* __restrict__ o_pay) {
  int holes = 0;
  for (int k = 0; k < K; ++k) {
    const int64_t at = static_cast<int64_t>(k) * n + d;
    const int rel = mb_rel[at];
    int r;  // this row's rank among d's new messages, -1 = keep
    if (base >= 0) {
      r = k - base;
    } else {
      const bool hole = rel == INT_MAX;
      r = hole ? holes : -1;
      holes += hole ? 1 : 0;
    }
    if (r >= 0 && r < c) {
      const int j = st + r;
      const Entry e = entry(j);
      o_rel[at] = e.drel;
      if (o_src != nullptr) o_src[at] = e.src;
      for (int p = 0; p < P; ++p)
        o_pay[(static_cast<int64_t>(k) * P + p) * n + d] =
            pay[static_cast<int64_t>(p) * S + j];
    } else {
      o_rel[at] = rel;
      if (o_src != nullptr) o_src[at] = mb_src[at];
      for (int p = 0; p < P; ++p) {
        const int64_t q = (static_cast<int64_t>(k) * P + p) * n + d;
        o_pay[q] = mb_pay[q];
      }
    }
  }
  return base >= 0 ? K - base : holes;
}

// Sum of v over the warp, in lane 0.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace tw
