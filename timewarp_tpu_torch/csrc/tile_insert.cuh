// The tile walk of K3 (sample_insert.cu): hole-ranked (commutative)
// insertion of a destination-sorted batch into the [K, N] mailbox, one
// CTA per tile of kTile consecutive nodes. It takes the batch entries
// through a functor, as insert_column.cuh does for K1, so K1 can move
// onto it.
//
// Node d's messages are batch entries start[d] .. start[d] + cnt[d] - 1,
// and the buckets are contiguous in node order (start[d + 1] = start[d] +
// cnt[d], as bucket_bounds gives them), so a tile's entries form one
// range [start[d0], start[dl] + cnt[dl]). The r-th message of d fills d's
// r-th empty row (mb_rel == INT32_MAX); every other row is copied
// through. The walk has three phases:
//
// A. Each thread loads its node's start/cnt and all K mailbox words of
//    its column, with no dependence between the loads, stages the first
//    kRows in shared memory, and keeps their hole mask. The tile scans
//    ins = min(cnt, holes) into each node's offset in the entry buffer.
// B. The CTA's threads stride over the tile's entry range (coalesced
//    batch loads), each loading kBatch entries before it draws them, so
//    their loads are in flight together. Each entry finds its node by a
//    binary search over the tile's starts in shared memory, so learns its
//    rank r. An entry with r < ins is drawn once and its deliver time,
//    sender and payload go to shared memory; every other entry is drawn
//    once for the counters only. No bucket sets the pace of a warp, and
//    no entry is drawn twice.
// C. Each thread writes its column's K output rows, coalesced across the
//    warp: filled holes from shared memory, every other row copied
//    through (rel from shared memory, payload and src from the mailbox).
//    The hole ranks of the kept rows come from the mask, so a plane's
//    loads are all issued before its stores. Each output word is written
//    exactly once.
//
// The entry buffer holds `cap` entries. A tile with more inserted
// entries than that runs B and C once per chunk of `cap` buffer slots:
// chunk c0 draws and writes only the entries whose slot falls in it, and
// the first chunk also draws the overflowing entries and copies the kept
// rows through, so every entry is still drawn once and every word written
// once.

#pragma once

#include <climits>
#include <cstdint>

#include "copy_async.cuh"
#include "insert_column.cuh"

namespace tw {

constexpr int kTile = 256;  // nodes of a tile = threads of its CTA
constexpr int kRows = 16;   // rows of a column staged in shared memory
constexpr int kBatch = 2;   // entries a thread loads before it draws them
static_assert(kRows <= 32, "the hole mask is one 32-bit word");
// shared words besides the entry buffer: the staged rows, starts,
// offsets (+1), the range's end, the scan's warp sums
constexpr int kTileWords =
    kRows * kTile + kTile + (kTile + 1) + 1 + kTile / 32;

// Entry-buffer words per entry: the deliver time, the sender (with an
// inbox src) and P payload words.
__host__ __device__ constexpr int tile_entry_words(int P, bool src) {
  return 1 + (src ? 1 : 0) + P;
}

// load(j) reads batch entry j's raw words; draw(raw, d) turns them into
// its (deliver time, sender), j belonging to node d. Both are called
// exactly once for every entry of the tile, in no order; the entries
// that overflow are drawn too (their result unused), so draw can count
// what it must. smem holds kTileWords + cap * tile_entry_words(P, o_src
// != nullptr) words. Returns this thread's overflow (its node's messages
// past the holes). Every thread of the CTA must call it.
template <class LoadFn, class DrawFn>
__device__ __forceinline__ int insert_tile(
    int n, int K, int P, int S, int cap, const int32_t* __restrict__ start,
    const int32_t* __restrict__ cnt, LoadFn&& load, DrawFn&& draw,
    const int32_t* __restrict__ pay, const int32_t* __restrict__ mb_rel,
    const int32_t* __restrict__ mb_src, const int32_t* __restrict__ mb_pay,
    int32_t* __restrict__ o_rel, int32_t* __restrict__ o_src,
    int32_t* __restrict__ o_pay, int32_t* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - d0);       // this tile's nodes
  const int d = d0 + tid;
  const bool own = tid < nv;
  const int kr = min(K, kRows);            // rows staged in shared memory
  int32_t* s_rows = smem;                  // [kRows, kTile]
  int32_t* s_st = s_rows + kRows * kTile;  // [kTile]
  int32_t* s_off = s_st + kTile;           // [kTile + 1]
  int32_t* s_hi = s_off + kTile + 1;       // [1]
  int32_t* s_wsum = s_hi + 1;              // [kTile / 32]
  int32_t* s_rel = smem + kTileWords;      // [cap]
  int32_t* s_src = s_rel + cap;            // [cap], with an inbox src
  int32_t* s_pay = s_rel + (o_src != nullptr ? 2 : 1) * cap;  // [P, cap]

  // A. the node's bucket and its mailbox column
  int st = 0, c = 0, holes = 0;
  uint32_t hm = 0;  // the hole mask of the staged rows
  if (own) {
    for (int k = 0; k < kr; ++k)
      copy_async(s_rows + k * kTile + tid,
                 mb_rel + static_cast<int64_t>(k) * n + d);
    st = start[d];
    c = cnt[d];
#pragma unroll 4
    for (int k = kRows; k < K; ++k)
      holes += mb_rel[static_cast<int64_t>(k) * n + d] == INT_MAX ? 1 : 0;
    copy_wait();
    for (int k = 0; k < kr; ++k)
      hm |= s_rows[k * kTile + tid] == INT_MAX ? 1u << k : 0u;
    holes += __popc(hm);
  }
  const int ins = min(c, holes);
  // exclusive scan of ins over the tile: each node's buffer offset
  int x = ins;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_wsum[warp] = x;
  s_st[tid] = own ? st : INT_MAX;
  if (tid == nv - 1) *s_hi = st + c;
  __syncthreads();
  int wbase = 0;
  for (int w = 0; w < warp; ++w) wbase += s_wsum[w];
  const int off = wbase + x - ins;
  s_off[tid] = off;
  if (tid == kTile - 1) s_off[kTile] = wbase + x;
  __syncthreads();
  const int lo = s_st[0], hi = *s_hi, total = s_off[kTile];

  for (int c0 = 0; c0 == 0 || c0 < total; c0 += cap) {
    // B. balanced draws over the tile's entry range: a thread loads
    // kBatch entries (a tile apart), then draws them; a kept entry's
    // payload goes to shared memory by asynchronous copy meanwhile
    for (int j0 = lo + tid; j0 < hi; j0 += kBatch * kTile) {
      decltype(load(0)) raw[kBatch];
      int node[kBatch], q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kTile;
        q[u] = -2;  // not drawn in this chunk; -1 drawn for the counters
        if (j < hi) {
          int a = 0, b = nv;  // the last node starting at or before j
          while (b - a > 1) {
            const int m = (a + b) >> 1;
            if (s_st[m] <= j) a = m; else b = m;
          }
          const int slot = s_off[a] + (j - s_st[a]);
          const bool kept = slot < s_off[a + 1];  // rank < ins of node a
          if (kept ? slot >= c0 && slot - c0 < cap : c0 == 0) {
            q[u] = kept ? slot - c0 : -1;
            node[u] = d0 + a;
            raw[u] = load(j);
            if (kept)
              for (int p = 0; p < P; ++p)
                copy_async(s_pay + p * cap + q[u],
                           pay + static_cast<int64_t>(p) * S + j);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (q[u] == -2) continue;
        const Entry e = draw(raw[u], node[u]);
        if (q[u] < 0) continue;
        s_rel[q[u]] = e.drel;
        if (o_src != nullptr) s_src[q[u]] = e.src;
      }
    }
    copy_wait();
    __syncthreads();
    // C. the column's rows, each written once, a plane at a time. The
    // hole ranks of the staged rows come from the mask; a plane's
    // copied-through rows come in by asynchronous copy into the staging
    // rows, all in flight at once, before any of its stores.
    if (own) {
      const auto slot_of = [&](int k, bool* fill) {
        const int h = __popc(hm & ((1u << k) - 1u));
        *fill = (hm >> k & 1u) != 0u && h < ins;
        return off + h - c0;
      };
      const auto put = [&](int k, int32_t* __restrict__ out, int64_t w,
                           const int32_t* buf) {
        bool fill;
        const int q = slot_of(k, &fill);
        if (fill) {
          if (q >= 0 && q < cap) out[w] = buf[q];
        } else if (c0 == 0) {
          out[w] = s_rows[k * kTile + tid];
        }
      };
      for (int k = 0; k < kr; ++k)
        put(k, o_rel, static_cast<int64_t>(k) * n + d, s_rel);
      const auto plane = [&](const int32_t* __restrict__ in,
                             int32_t* __restrict__ out, const int32_t* buf,
                             int64_t row, int64_t base) {
        if (c0 == 0) {
          for (int k = 0; k < kr; ++k) {
            bool fill;
            slot_of(k, &fill);
            if (!fill)
              copy_async(s_rows + k * kTile + tid, in + k * row + base + d);
          }
          copy_wait();
        }
        for (int k = 0; k < kr; ++k) put(k, out, k * row + base + d, buf);
      };
      if (o_src != nullptr) plane(mb_src, o_src, s_src, n, 0);
      for (int p = 0; p < P; ++p)
        plane(mb_pay, o_pay, s_pay + p * cap, static_cast<int64_t>(P) * n,
              static_cast<int64_t>(p) * n);
      // the rows past the staged ones, walked one at a time
      int h = __popc(hm);
      for (int k = kRows; k < K; ++k) {
        const int64_t at = static_cast<int64_t>(k) * n + d;
        const int rv = mb_rel[at];
        const bool hole = rv == INT_MAX;
        const int q = off + h - c0;
        const bool fill = hole && h < ins;
        h += hole ? 1 : 0;
        if (fill) {
          if (q >= 0 && q < cap) {
            o_rel[at] = s_rel[q];
            if (o_src != nullptr) o_src[at] = s_src[q];
            for (int p = 0; p < P; ++p)
              o_pay[(static_cast<int64_t>(k) * P + p) * n + d] =
                  s_pay[p * cap + q];
          }
        } else if (c0 == 0) {
          o_rel[at] = rv;
          if (o_src != nullptr) o_src[at] = mb_src[at];
          for (int p = 0; p < P; ++p) {
            const int64_t w = (static_cast<int64_t>(k) * P + p) * n + d;
            o_pay[w] = mb_pay[w];
          }
        }
      }
    }
    __syncthreads();
  }
  return c - ins;
}

}  // namespace tw
