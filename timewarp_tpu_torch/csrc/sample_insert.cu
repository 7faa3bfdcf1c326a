// K3 — sample and insert, the fused-sparse engine's kernel.
//
// Replaces the TPU kernel built by _build_kernel(mode="sample")
// (timewarp_tpu/interp/jax_engine/pallas_insert.py, sample branch) from
// FusedSparseEngine.__init__ and launched through _fused_insert_call
// (timewarp_tpu/interp/jax_engine/fused_sparse.py).
//
// What it computes: K1's hole-ranked (commutative) insertion of a batch
// sorted by (dst, woff, smrank) into the [K, N] mailbox, with each
// message's link delay drawn here. Node d's messages are batch entries
// start[d] .. start[d] + cnt[d] - 1. Entry j was sent at t + woff[j] by
// node smrank[j] / M from outbox slot smrank[j] % M; its entropy is the
// threefry msg_bits chain keyed by (src, d, send instant, slot), its
// delay the lowered link model (Fixed, Uniform, SeededHashUniform or
// LogNormal, optionally Quantize-wrapped), its flight max(delay, 1) and
// its epoch-relative deliver time min(woff + flight, INT32_MAX - 1). The
// r-th message of d fills d's r-th empty slot (mb_rel == INT32_MAX).
// Counters: overflow (messages past the holes), bad_delay (woff + flight
// > INT32_MAX - 1) and short_delay (flight < W, only when W > 1). Every
// entry is sampled exactly once and counted, those that overflow too.
//
// Bit-exactness: the integer models use uint32 arithmetic as the TPU
// kernel does. The lognormal draw matches PyTorch's own CUDA ops on the
// same card (the port's plain sampler): logf/cosf/expf/sqrtf as libdevice
// gives them, every product and sum rounded on its own (__fmul_rn,
// __fadd_rn: never contracted into an FMA where torch rounds twice),
// clipping as fminf(fmaxf(.)), and rintf (round half to even, as
// torch.round). No fast-math.
//
// What bounds it on an H100: memory traffic — each mailbox plane is read
// once and written once (K * (1 + P [+ 1 src]) int32 planes of N), plus
// start/cnt, woff and smrank of every valid batch entry and the payload
// of each entry that finds a hole (the dst column is not read: start/cnt
// stand in for it). At 2^20 nodes, K = 16, P = 2 with 5M messages that is
// ~490 MB, ~146 us at 3.35 TB/s; the threefry chain (~400 operations a
// message) takes a fifth of that even at the float32 rate.
//
// Design: one thread per node column walks its K rows (coalesced plane
// accesses; K1's walk, insert_column.cuh), draws each message of its own
// bucket when it meets a hole, then draws the bucket's remaining messages
// for the counters only. Each entry belongs to exactly one bucket, so
// there are no atomics on data and no scratch. The counters are warp sums
// plus one integer atomicAdd each per warp, exact in any order. Outputs
// are separate buffers.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "insert_column.cuh"

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;  // threefry key-schedule parity
constexpr uint32_t kMsgTag = 0x4D534721u;  // msg_bits domain tag
constexpr uint32_t kDrelMax = INT_MAX - 1;

enum LinkKind { kFixed = 0, kUniform = 1, kSeededHash = 2, kLogNormal = 3 };

struct Link {
  int kind;
  uint32_t quantum;  // 0 = no Quantize
  int needs_key;
  uint32_t i0, i1, i2, i3;
  float f0, f1, f2, f3;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Standard 20-round Threefry-2x32 (core/rng.py threefry2x32).
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, kRot[g % 2][i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return make_uint2(x0, x1);
}

// The lowered link model's delay (fused_sparse.lower_link).
__device__ __forceinline__ uint32_t draw_delay(const Link& L, uint32_t dst,
                                               uint32_t lo, uint32_t hi,
                                               uint2 key) {
  uint32_t d;
  switch (L.kind) {
    case kFixed:
      d = L.i0;
      break;
    case kUniform:
      d = L.i0 + key.x % L.i1;
      break;
    case kSeededHash:
      d = L.i0 + threefry(L.i2 ^ dst, L.i3, lo, hi).x % L.i1;
      break;
    default: {  // kLogNormal: Box-Muller normal_f32, then the lognormal
      const float u1 = __fadd_rn(
          __fmul_rn(static_cast<float>(key.x >> 8), 0x1p-24f), 0x1p-25f);
      const float u2 = __fmul_rn(static_cast<float>(key.y >> 8), 0x1p-24f);
      const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
      const float z =
          __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
      float v = __fmul_rn(L.f0, expf(__fmul_rn(L.f1, z)));
      v = fminf(fmaxf(v, L.f2), L.f3);
      d = static_cast<uint32_t>(rintf(v));
    }
  }
  if (L.quantum != 0u) {
    d = max(d, 1u);
    d = ((d + L.quantum - 1u) / L.quantum) * L.quantum;
  }
  return d;
}

// Draw batch entry j (destination d) and count it.
__device__ __forceinline__ tw::Entry draw(int j, uint32_t d,
                                      const int32_t* __restrict__ woff,
                                      const int32_t* __restrict__ smrank,
                                      uint32_t tl, uint32_t th, const Link& L,
                                      uint32_t s0, uint32_t s1, int M,
                                      uint32_t W, int& bad, int& shrt) {
  const uint32_t wo = static_cast<uint32_t>(woff[j]);
  const int32_t sm = smrank[j];
  const int32_t src = sm / M;  // smrank >= 0
  const uint32_t slot = static_cast<uint32_t>(sm - src * M);
  // send instant t + woff as two words with an explicit carry
  const uint32_t lo = tl + wo;
  const uint32_t hi = th + (lo < tl ? 1u : 0u);
  uint2 key = make_uint2(0u, 0u);
  if (L.needs_key) {
    const uint2 a = threefry(s0 ^ kMsgTag, s1, static_cast<uint32_t>(src), d);
    const uint2 b = threefry(a.x, a.y, lo, hi);
    key = threefry(b.x, b.y, slot, 0u);
  }
  const uint32_t flight = max(draw_delay(L, d, lo, hi, key), 1u);
  const uint32_t dsum = wo + flight;
  bad += dsum > kDrelMax ? 1 : 0;
  shrt += (W > 1u && flight < W) ? 1 : 0;
  return tw::Entry{static_cast<int32_t>(min(dsum, kDrelMax)), src};
}

__global__ void sample_insert_kernel(
    const int32_t* __restrict__ start, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ woff, const int32_t* __restrict__ smrank,
    const int32_t* __restrict__ pay, int S, const int64_t* __restrict__ tp,
    Link L, uint32_t s0, uint32_t s1, int M, uint32_t W,
    const int32_t* __restrict__ mb_rel, const int32_t* __restrict__ mb_src,
    const int32_t* __restrict__ mb_pay, int n, int K, int P,
    int32_t* __restrict__ o_rel, int32_t* __restrict__ o_src,
    int32_t* __restrict__ o_pay, int32_t* __restrict__ counters) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  int ovf = 0, bad = 0, shrt = 0;
  if (d < n) {
    const uint64_t t = static_cast<uint64_t>(*tp);
    const uint32_t tl = static_cast<uint32_t>(t);
    const uint32_t th = static_cast<uint32_t>(t >> 32);
    const int st = start[d];
    const int c = cnt[d];
    const auto entry = [&](int j) {
      return draw(j, static_cast<uint32_t>(d), woff, smrank, tl, th, L, s0,
                  s1, M, W, bad, shrt);
    };
    const int holes = tw::insert_column(d, n, K, P, S, st, c, -1, entry, pay,
                                        mb_rel, mb_src, mb_pay, o_rel, o_src,
                                        o_pay);
    // the messages that found no hole: drawn for the counters only
    for (int r = holes; r < c; ++r) entry(st + r);
    ovf = c > holes ? c - holes : 0;
  }
  ovf = tw::warp_sum(ovf);
  bad = tw::warp_sum(bad);
  shrt = tw::warp_sum(shrt);
  if ((threadIdx.x & 31) == 0) {
    if (ovf != 0) atomicAdd(counters + 0, ovf);
    if (bad != 0) atomicAdd(counters + 1, bad);
    if (shrt != 0) atomicAdd(counters + 2, shrt);
  }
}

}  // namespace

extern "C" const char* tw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// start, cnt int32[n]; woff, smrank int32[S]; pay int32[P, S]; tp int64[1]
// on the device (the epoch t); the lowered link (kind, quantum,
// needs_key, i0..i3, f0..f3); the engine's seed words s0, s1; max_out M;
// window W; mb_rel int32[K, n]; mb_src int32[K, n] or null (no inbox
// src: o_src unused); mb_pay int32[K, P, n]; outputs o_rel, o_src,
// o_pay of the same shapes; counters int32[3] (overflow, bad_delay,
// short_delay), zeroed by the caller. Returns the CUDA error of the
// launch.
extern "C" int tw_sample_insert(
    const int32_t* start, const int32_t* cnt, const int32_t* woff,
    const int32_t* smrank, const int32_t* pay, int S, const int64_t* tp,
    int kind, uint32_t quantum, int needs_key, uint32_t i0, uint32_t i1,
    uint32_t i2, uint32_t i3, float f0, float f1, float f2, float f3,
    uint32_t s0, uint32_t s1, int M, uint32_t W, const int32_t* mb_rel,
    const int32_t* mb_src, const int32_t* mb_pay, int n, int K, int P,
    int32_t* o_rel, int32_t* o_src, int32_t* o_pay, int32_t* counters,
    void* stream) {
  const Link L{kind, quantum, needs_key, i0, i1, i2, i3, f0, f1, f2, f3};
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  sample_insert_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      start, cnt, woff, smrank, pay, S, tp, L, s0, s1, M, W, mb_rel, mb_src,
      mb_pay, n, K, P, o_rel, o_src, o_pay, counters);
  return cudaGetLastError();
}
