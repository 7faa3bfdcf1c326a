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
// What bounds it on an H100: memory traffic. Each mailbox plane is read
// once and written once (K * (1 + P [+ 1 src]) int32 planes of N), plus
// start/cnt, woff and smrank of every valid batch entry and the payload
// of each entry that finds a hole (the dst column is not read: start/cnt
// stand in for it). At 2^20 nodes, K = 16, P = 2 with 5M messages that is
// ~490 MB, ~146 us at 3.35 TB/s. The draws come next: three threefry
// blocks and the lognormal a message, integer work at half the float32
// issue rate (chip_smoke counts the instructions in this library's SASS,
// tw_k3_draw_probe).
//
// Design: one CTA per tile of 256 consecutive nodes, on the tile walk it
// shares with K1 (tile_insert.cuh). The tile's entries, one contiguous
// range of the sorted batch, are drawn by all of the CTA's threads in
// turn, with coalesced batch loads, each entry once, so no bucket sets
// the pace of a warp; the columns' rows, the kept entries' payloads and
// the copied-through planes move between global and shared memory by
// cp.async (a full tile's rows 16 bytes a copy, shared by its threads),
// so no register waits on them and a thread needs at most 48 registers
// (five CTAs an SM); then each thread writes its column's rows once. (A thread that owns one node column and draws its whole bucket
// between its row loads, the TPU kernel's walk carried over, ran at 3.4x
// the byte bound.) The counters are warp sums plus one integer atomicAdd
// each per warp, exact in any order. Outputs are separate buffers.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_insert.cuh"

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

// Draw the batch entry sent at t + wo by smrank sm to destination d, and
// count it.
__device__ __forceinline__ tw::Entry draw(int32_t wo_, int32_t sm,
                                          uint32_t d, uint32_t tl,
                                          uint32_t th, const Link& L,
                                          uint32_t s0, uint32_t s1, int M,
                                          uint32_t W, int& bad, int& shrt) {
  const uint32_t wo = static_cast<uint32_t>(wo_);
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

// CTAs that must fit on an SM at once: at most 48 registers a thread
constexpr int kMinBlocks = 5;

__global__ void __launch_bounds__(tw::kTile, kMinBlocks)
    sample_insert_kernel(
    const int32_t* __restrict__ start, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ woff, const int32_t* __restrict__ smrank,
    const int32_t* __restrict__ pay, int S, const int64_t* __restrict__ tp,
    Link L, uint32_t s0, uint32_t s1, int M, uint32_t W,
    const int32_t* __restrict__ mb_rel, const int32_t* __restrict__ mb_src,
    const int32_t* __restrict__ mb_pay, int n, int K, int P, int cap,
    bool wide, int32_t* __restrict__ o_rel, int32_t* __restrict__ o_src,
    int32_t* __restrict__ o_pay, int32_t* __restrict__ counters) {
  extern __shared__ int32_t smem[];
  const uint64_t t = static_cast<uint64_t>(*tp);
  const uint32_t tl = static_cast<uint32_t>(t);
  const uint32_t th = static_cast<uint32_t>(t >> 32);
  int bad = 0, shrt = 0;
  int ovf = tw::insert_tile<true>(
      n, K, P, S, cap, wide, start, cnt, nullptr,
      [&](int j) { return make_int2(woff[j], smrank[j]); },
      [&](int2 raw, int d) {
        return draw(raw.x, raw.y, static_cast<uint32_t>(d), tl, th, L, s0,
                    s1, M, W, bad, shrt);
      },
      pay, mb_rel, mb_src, mb_pay, o_rel, o_src, o_pay, smem);
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
  const bool with_src = mb_src != nullptr;
  const int cap = tw::tile_cap(K, P, with_src);
  const size_t smem = tw::tile_smem_bytes(cap, P, with_src);
  const bool wide = tw::tile_wide(n, mb_rel, mb_src, mb_pay);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + tw::kTile - 1) / tw::kTile;
  sample_insert_kernel<<<blocks, tw::kTile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      start, cnt, woff, smrank, pay, S, tp, L, s0, s1, M, W, mb_rel, mb_src,
      mb_pay, n, K, P, cap, wide, o_rel, o_src, o_pay, counters);
  return cudaGetLastError();
}

// One draw of the main path's link, Quantize(LogNormal) with the message
// key, and nothing else around it but one load pair and one store:
// chip_smoke counts its SASS instructions for K3's operations bound.
// Never launched.
extern "C" __global__ void tw_k3_draw_probe(
    const int32_t* woff, const int32_t* smrank, uint32_t quantum, float f0,
    float f1, float f2, float f3, uint32_t tl, uint32_t th, uint32_t s0,
    uint32_t s1, int M, uint32_t W, int32_t* out) {
  const Link L{kLogNormal, quantum, 1, 0u, 0u, 0u, 0u, f0, f1, f2, f3};
  int bad = 0, shrt = 0;
  const tw::Entry e = draw(woff[threadIdx.x], smrank[threadIdx.x], 0u, tl,
                           th, L, s0, s1, M, W, bad, shrt);
  out[threadIdx.x] = e.drel + e.src + bad + shrt;
}
