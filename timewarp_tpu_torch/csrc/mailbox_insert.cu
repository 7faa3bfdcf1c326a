// K1 — mailbox insertion for the general engine.
//
// Replaces the TPU kernel built by _build_kernel(mode="drel") and
// launched by _fused_insert_call from PallasInsertStage.insert
// (timewarp_tpu/interp/jax_engine/pallas_insert.py).
//
// What it computes: merges a destination-sorted, pre-sampled batch into
// the [K, N] mailbox planes. Node d's messages are batch entries
// start[d] .. start[d] + cnt[d] - 1, the buckets contiguous in node
// order. Commutative inbox: the r-th message fills d's r-th empty slot
// (mb_rel == INT32_MAX). Ordered inbox: it fills row counts[d] + r.
// Messages that find no slot are summed into overflow. A fleet of B
// worlds is one launch: the world is the grid's y axis, and each world's
// planes, buckets, batch columns and overflow sit at its own offset.
//
// What bounds it on an H100: memory traffic — every mailbox plane is
// read once and written once (K * (1 + P [+ 1 src]) int32 planes of N),
// plus start/cnt and the gathered batch entries. At 2^17 nodes, K = 16,
// P = 1 that is ~36 MB, ~11 us at 3.35 TB/s.
//
// Design: K3's tile walk (tile_insert.cuh), one CTA per tile of 256
// consecutive nodes, with the entry's deliver time and sender read from
// the batch instead of drawn, and the overflowing entries not read at
// all. A thread that walks its own column row by row, gathering each
// message as its row comes up, waits on a load before every store and
// keeps few loads in flight: 3x the byte bound. Here the columns' rows
// (a full tile's 16 bytes a copy, shared by its threads) and the kept
// entries' payloads move by cp.async, all of a plane in flight before its
// stores; the tile's entries are loaded by all of its threads in turn,
// coalesced; each row is written once. An ordered node's fill rows are
// counts[d] .. K - 1 instead of its holes. At 2^17 nodes the 512 tiles
// run in one wave, every CTA in the same phase at once, so device memory
// idles while the entries come back: on an H100, under chip_smoke's
// timer, 2.4x the byte bound, where a launch of the grid with no work
// takes 0.7x. The TPU kernel's double-buffered VMEM blocks, lane-partial
// folds and 8-row tiling have no counterpart: the overflow is a warp
// reduction plus one integer atomicAdd per warp, exact in any order.
// Outputs are separate buffers, never the inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_insert.cuh"

namespace {

// CTAs that must fit on an SM at once: 2^17 nodes are 512 tiles, one
// wave on 132 SMs
constexpr int kMinBlocks = 4;

__global__ void __launch_bounds__(tw::kTile, kMinBlocks)
    mailbox_insert_kernel(
    const int32_t* __restrict__ start, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ drel,
    const int32_t* __restrict__ src, const int32_t* __restrict__ pay, int S,
    const int32_t* __restrict__ mb_rel, const int32_t* __restrict__ mb_src,
    const int32_t* __restrict__ mb_pay, int n, int K, int P, int cap,
    bool wide, int32_t* __restrict__ o_rel, int32_t* __restrict__ o_src,
    int32_t* __restrict__ o_pay, int32_t* __restrict__ overflow) {
  extern __shared__ int32_t smem[];
  // world blockIdx.y: every plane, batch column and counter at its offset
  const int64_t w = blockIdx.y;
  const int64_t wn = w * n, ws = w * S, wkn = w * K * n;
  start += wn;
  cnt += wn;
  if (counts != nullptr) counts += wn;
  drel += ws;
  if (src != nullptr) src += ws;
  pay += ws * P;
  mb_rel += wkn;
  if (mb_src != nullptr) mb_src += wkn;
  mb_pay += wkn * P;
  o_rel += wkn;
  if (o_src != nullptr) o_src += wkn;
  o_pay += wkn * P;
  int ovf = tw::insert_tile<false>(
      n, K, P, S, cap, wide, start, cnt, counts,
      [&](int j) { return tw::Entry{drel[j], src != nullptr ? src[j] : 0}; },
      [](tw::Entry e, int) { return e; }, pay, mb_rel, mb_src, mb_pay,
      o_rel, o_src, o_pay, smem);
  ovf = tw::warp_sum(ovf);
  if ((threadIdx.x & 31) == 0 && ovf != 0) atomicAdd(overflow + w, ovf);
}

}  // namespace

extern "C" const char* tw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B worlds, each laid out as one solo call, world-major: start, cnt
// int32[B, n], each world's buckets contiguous in node order; counts
// int32[B, n] with 0 <= counts <= K, or null (commutative); drel int32[B,
// S]; src int32[B, S] or null (no inbox src: mb_src, o_src unused); pay
// int32[B, P, S]; mb_rel, mb_src int32[B, K, n]; mb_pay int32[B, K, P, n];
// outputs o_rel, o_src, o_pay of the same shapes; overflow int32[B],
// zeroed by the caller. One launch for every world (grid: tiles x B).
// Returns the CUDA error of the launch.
extern "C" int tw_mailbox_insert(const int32_t* start, const int32_t* cnt,
                                 const int32_t* counts, const int32_t* drel,
                                 const int32_t* src, const int32_t* pay,
                                 int S, const int32_t* mb_rel,
                                 const int32_t* mb_src, const int32_t* mb_pay,
                                 int n, int K, int P, int B, int32_t* o_rel,
                                 int32_t* o_src, int32_t* o_pay,
                                 int32_t* overflow, void* stream) {
  const bool with_src = src != nullptr;
  const int cap = tw::tile_cap(K, P, with_src);
  const size_t smem = tw::tile_smem_bytes(cap, P, with_src);
  // every world's planes start 16-byte aligned when the first's do and n
  // is a multiple of 4 (a world is K * n words of a plane)
  const bool wide = tw::tile_wide(n, mb_rel, mb_src, mb_pay);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mailbox_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (B < 1 || B > 65535) return cudaErrorInvalidValue;
  const dim3 blocks((n + tw::kTile - 1) / tw::kTile, B);
  mailbox_insert_kernel<<<blocks, tw::kTile, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      start, cnt, counts, drel, src, pay, S, mb_rel, mb_src, mb_pay, n, K, P,
      cap, wide, o_rel, o_src, o_pay, overflow);
  return cudaGetLastError();
}
