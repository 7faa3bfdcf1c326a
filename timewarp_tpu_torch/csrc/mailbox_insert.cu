// K1 — mailbox insertion for the general engine.
//
// Replaces the TPU kernel built by _build_kernel(mode="drel") and
// launched by _fused_insert_call from PallasInsertStage.insert
// (timewarp_tpu/interp/jax_engine/pallas_insert.py).
//
// What it computes: merges a destination-sorted, pre-sampled batch into
// the [K, N] mailbox planes. Node d's messages are batch entries
// start[d] .. start[d] + cnt[d] - 1. Commutative inbox: the r-th message
// fills d's r-th empty slot (mb_rel == INT32_MAX), the hole rank being a
// running count down the K rows. Ordered inbox: it fills row
// counts[d] + r. Messages that find no slot are summed into overflow.
//
// What bounds it on an H100: memory traffic — every mailbox plane is
// read once and written once (K * (1 + P [+ 1 src]) int32 planes of N),
// plus start/cnt and the gathered batch entries. At 2^17 nodes, K = 16,
// P = 1 that is ~37 MB, ~11 us at 3.35 TB/s.
//
// Design: one thread per node column walks its K rows (insert_column.cuh),
// so each plane access is a coalesced 128-byte warp transaction; only the batch gathers are scattered, and they touch at
// most cnt[d] entries. The TPU kernel's double-buffered VMEM blocks,
// lane-partial folds and 8-row tiling have no counterpart: the overflow is
// a warp reduction plus one integer atomicAdd per warp, exact in any
// order. Outputs are separate buffers, never the inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "insert_column.cuh"

namespace {

__global__ void insert_kernel(const int32_t* __restrict__ start,
                              const int32_t* __restrict__ cnt,
                              const int32_t* __restrict__ counts,
                              const int32_t* __restrict__ drel,
                              const int32_t* __restrict__ src,
                              const int32_t* __restrict__ pay, int S,
                              const int32_t* __restrict__ mb_rel,
                              const int32_t* __restrict__ mb_src,
                              const int32_t* __restrict__ mb_pay, int n,
                              int K, int P, int32_t* __restrict__ o_rel,
                              int32_t* __restrict__ o_src,
                              int32_t* __restrict__ o_pay,
                              int32_t* __restrict__ overflow) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  int ovf = 0;
  if (d < n) {
    const int c = cnt[d];
    const int room = tw::insert_column(
        d, n, K, P, S, start[d], c, counts != nullptr ? counts[d] : -1,
        [&](int j) {
          return tw::Entry{drel[j], src != nullptr ? src[j] : 0};
        },
        pay, mb_rel, mb_src, mb_pay, o_rel, o_src, o_pay);
    ovf = c > room ? c - room : 0;
  }
  ovf = tw::warp_sum(ovf);
  if ((threadIdx.x & 31) == 0 && ovf != 0) atomicAdd(overflow, ovf);
}

}  // namespace

extern "C" const char* tw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// start, cnt int32[n]; counts int32[n] or null (commutative); drel
// int32[S]; src int32[S] or null (no inbox src: mb_src, o_src unused);
// pay int32[P, S]; mb_rel, mb_src int32[K, n]; mb_pay int32[K, P, n];
// outputs o_rel, o_src, o_pay of the same shapes; overflow int32[1],
// zeroed by the caller. Returns the CUDA error of the launch.
extern "C" int tw_mailbox_insert(const int32_t* start, const int32_t* cnt,
                                 const int32_t* counts, const int32_t* drel,
                                 const int32_t* src, const int32_t* pay,
                                 int S, const int32_t* mb_rel,
                                 const int32_t* mb_src, const int32_t* mb_pay,
                                 int n, int K, int P, int32_t* o_rel,
                                 int32_t* o_src, int32_t* o_pay,
                                 int32_t* overflow, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  insert_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      start, cnt, counts, drel, src, pay, S, mb_rel, mb_src, mb_pay, n, K, P,
      o_rel, o_src, o_pay, overflow);
  return cudaGetLastError();
}
