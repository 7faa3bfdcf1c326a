// K2 — fire-compaction for the general engine's adaptive routing stage.
//
// Replaces the TPU kernel built by _build_compact_kernel and launched by
// _fire_compact_call (timewarp_tpu/interp/jax_engine/pallas_insert.py).
//
// What it computes: stream compaction of the raw outbox planes. A lane
// with dst >= 0 is a message; it is written as (dst, woff, smrank =
// node*M + slot, payload...) into a batch of static width S, in the
// reference's order: segments of 1024 nodes, grouped in blocks of RW
// node rows (RW = 8 when the row count is a multiple of 8, else 1), and
// inside a block slot-major, then row, then lane. Past the fired count
// the batch holds the sentinel dst = n (woff, smrank, payload 0).
// Messages beyond S are counted as drops: max(total - S, 0).
//
// What bounds it on an H100: memory traffic. It reads the M dst planes
// (twice: count, then scatter), the woff plane and the payload of the
// valid lanes, and writes the batch — a few MB per superstep at 2^17
// nodes, a few microseconds at 3.35 TB/s. There is no arithmetic to
// speak of.
//
// Design: the TPU kernel walked the blocks in order on one core,
// carrying the running write base, and built prefix sums from lane
// rolls. Here one CTA of 1024 threads owns one segment (block, slot,
// row), so every read is coalesced: (1) each CTA counts its valid lanes
// with __syncthreads_count; (2) one CTA scans the segment counts into
// write bases (the sequential carry of the TPU grid becomes this scan);
// (3) each CTA writes its lanes at base + in-segment prefix (warp ballot
// + popc, then a scan of the 32 warp counts) and fills its share of the
// sentinel tail. Nothing is atomic, so the result is deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;

__device__ __forceinline__ void segment_coords(int seg, int M, int RW,
                                               int* row, int* slot) {
  const int r = seg % RW;
  const int bm = seg / RW;
  *slot = bm % M;
  *row = (bm / M) * RW + r;
}

__global__ void count_kernel(const int32_t* __restrict__ pdst, int n,
                             int M, int RW, int32_t* __restrict__ seg_count) {
  int row, slot;
  segment_coords(blockIdx.x, M, RW, &row, &slot);
  const int node = row * kLanes + threadIdx.x;
  const bool v = node < n && pdst[(int64_t)slot * n + node] >= 0;
  const int c = __syncthreads_count(v);
  if (threadIdx.x == 0) seg_count[blockIdx.x] = c;
}

// One CTA of 1024 threads: exclusive scan of seg[0..nseg) in place;
// seg[nseg] = total; drops = max(total - S, 0).
__global__ void scan_kernel(int32_t* __restrict__ seg, int nseg, int S,
                            int32_t* __restrict__ drops) {
  __shared__ int32_t warp_tot[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (nseg + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, nseg), hi = min(lo + per, nseg);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += seg[i];
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = x - local + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = seg[i];
    seg[i] = run;
    run += c;
  }
  if (tid == (int)blockDim.x - 1) {
    seg[nseg] = run;
    *drops = run > S ? run - S : 0;
  }
}

__global__ void scatter_kernel(const int32_t* __restrict__ pdst,
                               const int32_t* __restrict__ woff_n,
                               const int32_t* __restrict__ payload,
                               int n, int M, int P, int RW, int S, int nseg,
                               const int32_t* __restrict__ seg_base,
                               int32_t* __restrict__ out_dst,
                               int32_t* __restrict__ out_woff,
                               int32_t* __restrict__ out_smrank,
                               int32_t* __restrict__ out_pay) {
  __shared__ int32_t warp_base[32];
  int row, slot;
  segment_coords(blockIdx.x, M, RW, &row, &slot);
  const int node = row * kLanes + threadIdx.x;
  const int d = node < n ? pdst[(int64_t)slot * n + node] : -1;
  const bool v = d >= 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, v);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int c = warp_base[lane];
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    warp_base[lane] = x - c;  // exclusive
  }
  __syncthreads();
  const int pos = seg_base[blockIdx.x] + warp_base[warp] + in_warp;
  if (v && pos < S) {
    out_dst[pos] = d;
    out_woff[pos] = woff_n != nullptr ? woff_n[node] : 0;
    out_smrank[pos] = node * M + slot;
    for (int p = 0; p < P; ++p)
      out_pay[(int64_t)p * S + pos] =
          payload[((int64_t)slot * P + p) * n + node];
  }
  // this CTA's share of the sentinel tail [min(total, S), S)
  const int fired = min(seg_base[nseg], S);
  const int chunk = (S + gridDim.x - 1) / gridDim.x;
  const int t0 = max((int)blockIdx.x * chunk, fired);
  const int t1 = min((int)(blockIdx.x + 1) * chunk, S);
  for (int q = t0 + threadIdx.x; q < t1; q += blockDim.x) {
    out_dst[q] = n;
    out_woff[q] = 0;
    out_smrank[q] = 0;
    for (int p = 0; p < P; ++p) out_pay[(int64_t)p * S + q] = 0;
  }
}

}  // namespace

extern "C" const char* tw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pdst int32[M, n], woff_n int32[n] or null (window 1), payload
// int32[M, P, n]; scratch int32[ceil(n/1024)*M + 1]; outputs dst, woff,
// smrank int32[S], pay int32[P, S], drops int32[1]. Returns the CUDA
// error of the launches (0 = launched).
extern "C" int tw_fire_compact(const int32_t* pdst, const int32_t* woff_n,
                               const int32_t* payload, int n, int M, int P,
                               int S, int32_t* scratch, int32_t* out_dst,
                               int32_t* out_woff, int32_t* out_smrank,
                               int32_t* out_pay, int32_t* drops,
                               void* stream) {
  const int NR = (n + kLanes - 1) / kLanes;
  const int RW = NR % 8 == 0 ? 8 : 1;
  const int nseg = NR * M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_kernel<<<nseg, kLanes, 0, s>>>(pdst, n, M, RW, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<1, 1024, 0, s>>>(scratch, nseg, S, drops);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_kernel<<<nseg, kLanes, 0, s>>>(pdst, woff_n, payload, n, M, P, RW,
                                         S, nseg, scratch, out_dst, out_woff,
                                         out_smrank, out_pay);
  return cudaGetLastError();
}
