// The tile walk of K1 (mailbox_insert.cu) and K3 (sample_insert.cu):
// insertion of a destination-sorted batch into the [K, N] mailbox, one
// CTA per tile of kTile consecutive nodes. The kernels differ only in how
// a batch entry becomes its (deliver time, sender): K1 reads them, K3
// draws the delay from the entry's send instant and sender.
//
// Node d's messages are batch entries start[d] .. start[d] + cnt[d] - 1,
// and the buckets are contiguous in node order (start[d + 1] = start[d] +
// cnt[d], as bucket_bounds gives them), so a tile's entries form one
// range [start[d0], start[dl] + cnt[dl]). The r-th message of d fills d's
// r-th fill row: a commutative node's fill rows are its empty rows
// (mb_rel == INT32_MAX), an ordered node's are rows base[d] .. K - 1 (its
// kept rows come first), so message r fills row base[d] + r. Every other
// row is copied through. The walk has three phases:
//
// A. Each thread loads its node's start/cnt and all K mailbox words of
//    its column, with no dependence between the loads, stages the first
//    kRows in shared memory (a full tile's 16 bytes a copy, shared by its
//    threads, where the planes are aligned), and keeps their fill mask.
//    The tile scans ins = min(cnt, fill rows) into each node's offset in
//    the entry buffer.
// B. The CTA's threads stride over the tile's entry range (coalesced
//    batch loads), each loading kBatch entries before it draws them, so
//    their loads are in flight together. Each entry finds its node by a
//    binary search over the tile's starts in shared memory, so learns its
//    rank r. An entry with r < ins is loaded and drawn once and its
//    deliver time, sender and payload go to shared memory. An entry past
//    ins overflows: with kDrawAll it is loaded and drawn once for the
//    caller's counters, else it is not read at all. No bucket sets the
//    pace of a warp, and no entry is drawn twice.
// C. Each thread writes its column's K output rows, coalesced across the
//    warp: filled rows from shared memory, every other row copied through
//    (rel from shared memory, payload and src from the mailbox). The
//    ranks of the staged rows come from the mask (the popcount below row
//    k: the hole rank, or k - base), so a plane's loads are all issued
//    before its stores. Each output word is written exactly once.
//
// The entry buffer holds `cap` entries. A tile with more inserted
// entries than that runs B and C once per chunk of `cap` buffer slots:
// chunk c0 draws and writes only the entries whose slot falls in it, and
// the first chunk also draws the overflowing entries (with kDrawAll) and
// copies the kept rows through, so every entry is still drawn at most
// once and every word written once.

#pragma once

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>

#include "copy_async.cuh"

namespace tw {

// A batch entry as it is inserted: epoch-relative deliver time, sender.
struct Entry {
  int32_t drel;
  int32_t src;
};

// Sum of v over the warp, in lane 0.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kTile = 256;  // nodes of a tile = threads of its CTA
constexpr int kRows = 16;   // rows of a column staged in shared memory
constexpr int kBatch = 2;   // entries a thread loads before it draws them
static_assert(kRows <= 32, "the fill mask is one 32-bit word");
// shared words besides the entry buffer: the staged rows, starts,
// offsets (+1), the range's end, the scan's warp sums
constexpr int kTileWords =
    kRows * kTile + kTile + (kTile + 1) + 1 + kTile / 32;

// Rows 0 .. kr - 1 of a plane's tile (the kTile columns from `in`, its
// rows `row` words apart) into `rows` (kTile words apart), 16 bytes a
// copy, shared by all of the CTA's threads: a quarter of the copies of a
// column a thread. `in` and `row` keep every copy 16-byte aligned.
__device__ __forceinline__ void copy_tile_rows(int32_t* rows,
                                               const int32_t* in,
                                               int64_t row, int kr) {
  constexpr int kChunks = kTile / 4;  // 16-byte chunks of a row
  for (int c = threadIdx.x; c < kr * kChunks; c += kTile) {
    const int k = c / kChunks, m = (c - k * kChunks) * 4;
    copy_async16(rows + k * kTile + m, in + k * row + m);
  }
}

// Entry-buffer words per entry: the deliver time, the sender (with an
// inbox src) and P payload words.
__host__ __device__ constexpr int tile_entry_words(int P, bool src) {
  return 1 + (src ? 1 : 0) + P;
}

// The entry buffer's capacity: room for 8 kept entries a node (a tile
// chunks past that), within 96 KB; a tile never keeps more than kTile * K.
inline int tile_cap(int K, int P, bool src) {
  constexpr int kKeptPerNode = 8;
  constexpr int kBufferBytes = 96 * 1024;
  return std::max(1, std::min(kTile * std::min(K, kKeptPerNode),
                              kBufferBytes / (4 * tile_entry_words(P, src))));
}

// Dynamic shared memory of a CTA with an entry buffer of cap entries.
inline size_t tile_smem_bytes(int cap, int P, bool src) {
  return (static_cast<size_t>(kTileWords) +
          static_cast<size_t>(cap) * tile_entry_words(P, src)) *
         sizeof(int32_t);
}

// Whether a tile's rows can move 16 bytes a copy: n a multiple of 4 and
// every plane 16-byte aligned (mb_src null without an inbox src).
inline bool tile_wide(int n, const int32_t* mb_rel, const int32_t* mb_src,
                      const int32_t* mb_pay) {
  const auto aligned = [](const int32_t* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  return n % 4 == 0 && aligned(mb_rel) && aligned(mb_pay) &&
         (mb_src == nullptr || aligned(mb_src));
}

// load(j) reads batch entry j's raw words; draw(raw, d) turns them into
// its Entry, j belonging to node d. Both are called at most once for
// every entry of the tile, in no order: for each entry that finds a row,
// and with kDrawAll for the overflowing ones too (their result unused),
// so draw can count what it must. base is null for commutative inboxes,
// else each node's kept rows (0 <= base[d] <= K). smem holds
// tile_smem_bytes(cap, P, o_src != nullptr). With `wide` (tile_wide) a
// full tile's staged rows come in 16 bytes a copy, shared by its threads,
// instead of a column a thread. Returns this thread's overflow: its
// node's messages past its room (its holes, or K - base[d]). Every thread
// of the CTA must call it.
template <bool kDrawAll, class LoadFn, class DrawFn>
__device__ __forceinline__ int insert_tile(
    int n, int K, int P, int S, int cap, bool wide,
    const int32_t* __restrict__ start,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ base,
    LoadFn&& load, DrawFn&& draw, const int32_t* __restrict__ pay,
    const int32_t* __restrict__ mb_rel, const int32_t* __restrict__ mb_src,
    const int32_t* __restrict__ mb_pay, int32_t* __restrict__ o_rel,
    int32_t* __restrict__ o_src, int32_t* __restrict__ o_pay,
    int32_t* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - d0);       // this tile's nodes
  const int d = d0 + tid;
  const bool own = tid < nv;
  const bool vec = wide && nv == kTile;    // rows by 16-byte copies
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
  int st = 0, c = 0, room = 0;
  int b = -1;       // the node's first fill row if ordered, -1 commutative
  uint32_t fm = 0;  // the fill mask of the staged rows
  if (vec) {
    copy_tile_rows(s_rows, mb_rel + d0, n, kr);
  } else if (own) {
    for (int k = 0; k < kr; ++k)
      copy_async(s_rows + k * kTile + tid,
                 mb_rel + static_cast<int64_t>(k) * n + d);
  }
  if (own) {
    st = start[d];
    c = cnt[d];
    if (base != nullptr) {
      b = base[d];
      room = K - b;
      fm = b < kr ? ((1u << kr) - 1u) & ~((1u << b) - 1u) : 0u;
    } else {
#pragma unroll 4
      for (int k = kRows; k < K; ++k)
        room += mb_rel[static_cast<int64_t>(k) * n + d] == INT_MAX ? 1 : 0;
    }
  }
  copy_wait();
  if (vec) __syncthreads();
  if (own && b < 0) {
    for (int k = 0; k < kr; ++k)
      fm |= s_rows[k * kTile + tid] == INT_MAX ? 1u << k : 0u;
    room += __popc(fm);
  }
  const int ins = max(0, min(c, room));
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
          int a = 0, e = nv;  // the last node starting at or before j
          while (e - a > 1) {
            const int m = (a + e) >> 1;
            if (s_st[m] <= j) a = m; else e = m;
          }
          const int slot = s_off[a] + (j - s_st[a]);
          const bool kept = slot < s_off[a + 1];  // rank < ins of node a
          if (kept ? slot >= c0 && slot - c0 < cap : kDrawAll && c0 == 0) {
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
        const Entry en = draw(raw[u], node[u]);
        if (q[u] < 0) continue;
        s_rel[q[u]] = en.drel;
        if (o_src != nullptr) s_src[q[u]] = en.src;
      }
    }
    copy_wait();
    __syncthreads();
    // C. the column's rows, each written once, a plane at a time. The
    // ranks of the staged rows come from the mask; a plane's
    // copied-through rows come in by asynchronous copy into the staging
    // rows (a full, aligned tile's all at once, 16 bytes a copy, shared
    // by the CTA's threads), all in flight before any of its stores.
    const auto slot_of = [&](int k, bool* fill) {
      const int h = __popc(fm & ((1u << k) - 1u));
      *fill = (fm >> k & 1u) != 0u && h < ins;
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
    if (own)
      for (int k = 0; k < kr; ++k)
        put(k, o_rel, static_cast<int64_t>(k) * n + d, s_rel);
    const auto plane = [&](const int32_t* __restrict__ in,
                           int32_t* __restrict__ out, const int32_t* buf,
                           int64_t row, int64_t off0) {
      if (c0 == 0 && vec) {
        __syncthreads();  // every column's stores have read the rows
        copy_tile_rows(s_rows, in + off0 + d0, row, kr);
        copy_wait();
        __syncthreads();
      } else if (c0 == 0 && own) {
        for (int k = 0; k < kr; ++k) {
          bool fill;
          slot_of(k, &fill);
          if (!fill)
            copy_async(s_rows + k * kTile + tid, in + k * row + off0 + d);
        }
        copy_wait();
      }
      if (own)
        for (int k = 0; k < kr; ++k) put(k, out, k * row + off0 + d, buf);
    };
    if (o_src != nullptr) plane(mb_src, o_src, s_src, n, 0);
    for (int p = 0; p < P; ++p)
      plane(mb_pay, o_pay, s_pay + p * cap, static_cast<int64_t>(P) * n,
            static_cast<int64_t>(p) * n);
    if (own) {
      // the rows past the staged ones, walked one at a time; h is the
      // next fill row's rank
      int h = __popc(fm);
      for (int k = kRows; k < K; ++k) {
        const int64_t at = static_cast<int64_t>(k) * n + d;
        const int rv = mb_rel[at];
        const bool fillable = b >= 0 ? k >= b : rv == INT_MAX;
        const int q = off + h - c0;
        const bool fill = fillable && h < ins;
        h += fillable ? 1 : 0;
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
  return c > room ? c - room : 0;
}

}  // namespace tw
