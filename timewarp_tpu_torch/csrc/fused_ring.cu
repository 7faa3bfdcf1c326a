// K4 — the dense token ring's whole superstep, FusedRingEngine's kernel.
//
// Replaces the TPU kernel launched by FusedRingEngine._superstep
// (timewarp_tpu/interp/jax_engine/fused_ring.py, pallas_call of
// _superstep_kernel, whose arithmetic is _block_compute).
//
// What it computes, for every node i of the lean ring at the superstep's
// epoch-relative instant t (all times int32 relative to the epoch,
// INT32_MAX = empty / never), from the ten int32 planes of N
// (QR0, QR1, QV0, QV1, QK0, QK1, WAKE, CNT, VAL, SEND):
//   1. fire: min(WAKE, QR0, QR1) == t; deliver each due queue slot;
//   2. the lean ring step (models/token_ring.py, with_observer=False):
//      count and max the delivered tokens, arm the think timer, forward
//      one token if due and alive, rearm or disarm;
//   3. route the send to node i + 1 (node N-1 wraps to node 0);
//   4. rebase the kept slots to the new epoch t and insert the arriving
//      token (deliver time drel) into the first free slot of two; a token
//      that finds both full is counted in overflow. A slot that takes
//      nothing keeps its old QV/QK words, stale ones included;
//   5. rebase WAKE and SEND (contract #5: a rearmed wake is at least t+1).
// delivered (d0 + d1) and overflow are summed into acc[0] and acc[1].
// Arithmetic wraps modulo 2^32 as the TPU's int32 does (t + think is in
// range under the engine's 2*think + drel < INT32_MAX guard, except from
// an initial state whose first event is that far out).
//
// What bounds it on an H100: memory traffic — each of the ten planes is
// read once and written once, 80 B a node: 83 886 080 B at 2^20 nodes,
// 0.025 ms at 3.35 TB/s. The arithmetic is a few dozen integer operations
// a node.
//
// Design: one thread per node over a 1-D grid; each plane access is a
// coalesced warp transaction. The ring shift replaces the TPU's block
// carry and wrap scalars: each CTA puts its nodes' outboxes (due, val1+1)
// in shared memory, and thread 0 recomputes, from the input planes, the
// outbox of the node just before the CTA's first node (node N-1 for the
// CTA that holds node 0). No grid-wide synchronisation and no dependence
// on block order. The output is a second buffer: a CTA reads its
// neighbour's input planes while other CTAs write, so an in-place update
// could read a node that is already updated. The counters are a block sum
// and one 64-bit atomicAdd each per CTA.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kMaxi = INT_MAX;
constexpr int32_t kNeg = INT_MIN;
constexpr int32_t kToken = 0;
// the plane order of FusedRingState.planes
enum Plane { QR0, QR1, QV0, QV1, QK0, QK1, WAKE, CNT, VAL, SEND };

// int32 arithmetic modulo 2^32 (signed overflow is undefined in C++)
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

struct Scalars {
  int32_t t;      // the superstep's instant, relative to the epoch
  int alive;      // epoch + t < end_us: one value for the superstep
  int32_t think;  // think_us
  int32_t drel;   // the link's delay, >= 1
};

// One node's ten planes.
struct Cell {
  int32_t p[10];
};

__device__ __forceinline__ Cell load(const int32_t* __restrict__ in,
                                     int64_t n, int64_t i) {
  Cell c;
#pragma unroll
  for (int k = 0; k < 10; ++k) c.p[k] = in[k * n + i];
  return c;
}

// Steps 1-2 for one node: what it fires, delivers and sends.
struct Fired {
  bool fire, d0, d1, due;
  int32_t val1, cnt2, send2;
};

__device__ __forceinline__ Fired fire_step(const Cell& c, const Scalars& S) {
  Fired f;
  const int32_t r0 = c.p[QR0], r1 = c.p[QR1];
  f.fire = min(c.p[WAKE], min(r0, r1)) == S.t;
  f.d0 = r0 <= S.t && f.fire;
  f.d1 = r1 <= S.t && f.fire;
  // commutative inbox: the reductions are slot-order free
  const bool tok0 = f.d0 && c.p[QK0] == kToken;
  const bool tok1 = f.d1 && c.p[QK1] == kToken;
  const bool got = tok0 || tok1;
  const int32_t cnt1 =
      wadd(wadd(c.p[CNT], tok0 ? 1 : 0), tok1 ? 1 : 0);
  const int32_t vmax = max(tok0 ? c.p[QV0] : kNeg, tok1 ? c.p[QV1] : kNeg);
  f.val1 = got ? max(c.p[VAL], vmax) : c.p[VAL];
  const int32_t s = c.p[SEND];
  const int32_t armed = wadd(S.t, S.think);
  const int32_t send1 = (got && s >= kMaxi) ? armed : s;
  f.due = send1 <= S.t && cnt1 > 0 && S.alive && f.fire;
  f.cnt2 = S.alive ? wsub(cnt1, f.due ? 1 : 0) : 0;
  f.send2 = f.due ? (f.cnt2 > 0 ? armed : kMaxi) : (S.alive ? send1 : kMaxi);
  return f;
}

// the rebase of a relative time that stays armed
__device__ __forceinline__ int32_t rebase(int32_t x, int32_t t) {
  return x >= kMaxi ? kMaxi : wsub(x, t);
}

__global__ void __launch_bounds__(kThreads) fused_ring_kernel(
    const int32_t* __restrict__ in, int32_t* __restrict__ out, int n,
    Scalars S, unsigned long long* __restrict__ acc) {
  // box[j + 1] is the outbox of this CTA's node j; box[0] its
  // predecessor's
  __shared__ int32_t box_v[kThreads + 1];
  __shared__ int32_t box_x[kThreads + 1];
  __shared__ int sums[2][kThreads / 32];
  const int64_t nn = n;
  const int first = blockIdx.x * kThreads;
  const int i = first + threadIdx.x;
  const bool mine = i < n;
  Cell c{};
  Fired f{};
  if (mine) {
    c = load(in, nn, i);
    f = fire_step(c, S);
    box_v[threadIdx.x + 1] = f.due;
    box_x[threadIdx.x + 1] = wadd(f.val1, 1);
  }
  if (threadIdx.x == 0) {
    const Fired g = fire_step(load(in, nn, first == 0 ? n - 1 : first - 1),
                              S);
    box_v[0] = g.due;
    box_x[0] = wadd(g.val1, 1);
  }
  __syncthreads();
  int deliv = 0, ovf = 0;
  if (mine) {
    const bool in_v = box_v[threadIdx.x] != 0;
    const int32_t in_x = box_x[threadIdx.x];
    const int32_t r0 = c.p[QR0], r1 = c.p[QR1];
    const int32_t rel0 = (r0 < kMaxi && !f.d0) ? wsub(r0, S.t) : kMaxi;
    const int32_t rel1 = (r1 < kMaxi && !f.d1) ? wsub(r1, S.t) : kMaxi;
    const bool free0 = rel0 >= kMaxi;
    const bool free1 = rel1 >= kMaxi;
    const bool ins0 = in_v && free0;
    const bool ins1 = in_v && !free0 && free1;
    int32_t o[10];
    o[QR0] = ins0 ? S.drel : rel0;
    o[QR1] = ins1 ? S.drel : rel1;
    o[QV0] = ins0 ? in_x : c.p[QV0];
    o[QV1] = ins1 ? in_x : c.p[QV1];
    o[QK0] = ins0 ? kToken : c.p[QK0];
    o[QK1] = ins1 ? kToken : c.p[QK1];
    if (f.fire) {
      o[WAKE] = f.send2 >= kMaxi
                    ? kMaxi
                    : wsub(max(f.send2, wadd(S.t, 1)), S.t);
      o[CNT] = f.cnt2;
      o[VAL] = f.val1;
      o[SEND] = rebase(f.send2, S.t);
    } else {
      o[WAKE] = rebase(c.p[WAKE], S.t);
      o[CNT] = c.p[CNT];
      o[VAL] = c.p[VAL];
      o[SEND] = rebase(c.p[SEND], S.t);
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) out[k * nn + i] = o[k];
    deliv = (f.d0 ? 1 : 0) + (f.d1 ? 1 : 0);
    ovf = (in_v && !free0 && !free1) ? 1 : 0;
  }
  // block sums, then one atomic per counter per CTA
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    deliv += __shfl_down_sync(0xffffffffu, deliv, off);
    ovf += __shfl_down_sync(0xffffffffu, ovf, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    sums[0][warp] = deliv;
    sums[1][warp] = ovf;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    deliv = threadIdx.x < kThreads / 32 ? sums[0][threadIdx.x] : 0;
    ovf = threadIdx.x < kThreads / 32 ? sums[1][threadIdx.x] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      deliv += __shfl_down_sync(0xffffffffu, deliv, off);
      ovf += __shfl_down_sync(0xffffffffu, ovf, off);
    }
    if (threadIdx.x == 0) {
      using u64 = unsigned long long;
      if (deliv != 0) atomicAdd(acc + 0, static_cast<u64>(deliv));
      if (ovf != 0) atomicAdd(acc + 1, static_cast<u64>(ovf));
    }
  }
}

}  // namespace

extern "C" const char* tw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in, out int32[10, n] (separate buffers); the superstep's scalars t,
// alive, think, drel; acc int64[2] on the device, to which the kernel adds
// (delivered, overflow). n >= 1. Returns the CUDA error of the launch.
extern "C" int tw_fused_ring(const int32_t* in, int32_t* out, int n,
                             int32_t t, int alive, int32_t think,
                             int32_t drel, unsigned long long* acc,
                             void* stream) {
  const Scalars S{t, alive, think, drel};
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_ring_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(in, out, n, S,
                                                           acc);
  return cudaGetLastError();
}
