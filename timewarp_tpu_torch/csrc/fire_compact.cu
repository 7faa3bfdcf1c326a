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
// Messages beyond S are counted as drops: max(total - S, 0). A fleet
// of B worlds is one launch: each world is compacted into its own batch
// row, as a solo call would, its prefix and drops restarting at it.
//
// What bounds it on an H100: memory traffic. It reads the M dst planes,
// the woff plane and the payload of the valid lanes, and writes the batch:
// about 10 MB at 2^17 nodes, M = 8, P = 1, S = 2^18, under 3 us at
// 3.35 TB/s. There is no arithmetic to speak of, so the fixed costs of a
// launch and of every step that waits on memory or on other CTAs weigh as
// much as the bytes.
//
// Design: the TPU kernel walked the blocks in order on one core, carrying
// the running write base. Here one cooperative launch of a persistent
// grid, as many 256-thread CTAs as the card holds at once (the occupancy
// query runs once per device and payload width), does the count, the
// scan and the scatter, with one grid.sync() between them. The sync is
// this design's own cost: no CTA writes before every CTA has read. The write order is cut into units
// of 256 lanes (a quarter segment), and each CTA takes a contiguous range
// of units in that order:
//   1. it loads its units' dst lanes into registers, eight units at a
//      time, and stages their woff and payload words in shared memory by
//      cp.async, not waited for until step 3; it writes each warp's
//      valid count per unit to scratch, and its own total;
//   2. grid.sync(); each CTA loads every CTA total at once and sums those
//      before it (its write base) and all (the fired count);
//   3. it writes its lanes at base + the unit's warp prefix + the ballot
//      prefix inside the warp, unit after unit (units past the first
//      eight are loaded again, from L2), and its share of the sentinel
//      tail; the last CTA writes drops.
// Reading the payload words in step 3 instead, straight from global
// memory, put a memory latency after the grid sync: 2.6 us more at the
// slice shape. The loops over the P payload words run outside the
// unrolled loops over a batch's units (a loop inside each unit measured
// 0.9 us slower). The staging takes 8 KB of shared memory a CTA per
// staged word (woff and P payload words), so an H100 (227 KB a CTA)
// stages P up to 27 (tw_fire_compact_narrow_max says how many words the
// device's shared memory holds).
// A wider payload takes the second instantiation (kWide): it stages woff
// alone and reads the payload words from global memory in step 3, a
// memory latency after the grid sync, the cost measured above. The
// narrow instantiation (kWide false) is the code above, unchanged. The
// wrapper picks one from P; nothing retries a refused launch.
// Every load of a step is issued before the first that waits on it, and
// no unit index is divided per unit (UnitPos steps through them). Nothing
// is atomic, so the result is deterministic. The scratch is the caller's,
// fresh each call: wcnt int32[B * units * 8], then ctatot int32[jobs].
//
// The world axis: the segmented scan is a scan per world. Each world's
// units are cut into Gw contiguous jobs (Gw = the resident CTAs / B, at
// most its units), and the grid takes the B * Gw jobs, one a CTA while
// the card holds them all, else several a CTA, a grid apart (only the
// first job's first batch stays in registers then). A job's write base
// sums only the totals of its own world's earlier jobs, so each world's
// prefix, tail and drops start afresh; at B = 1 the jobs are the solo
// grid's CTAs, unit for unit, and the kernel is its solo instantiation
// (kFleet false), where the world offsets are constants: the first
// world-axis build held 8 more pointers a thread and spilled, and read
// 20% slower at the slice shape.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "copy_async.cuh"

namespace cg = cooperative_groups;
using tw::copy_async;
using tw::copy_wait;

namespace {

constexpr int kLanes = 1024;              // the reference's segment width
constexpr int kT = 256;                   // threads a CTA = lanes a unit
constexpr int kUnitsPerSeg = kLanes / kT;
constexpr int kWarps = kT / 32;
constexpr int kBatch = 8;                 // units a thread loads together
// CTAs that must fit on an SM at once: at most 64 registers a thread
constexpr int kMinBlocks = 4;
constexpr int kTotals = 8;                // CTA totals a thread loads at once
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void segment_coords(int seg, int M, int RW,
                                               int* row, int* slot) {
  const int r = seg % RW;
  const int bm = seg / RW;
  *slot = bm % M;
  *row = (bm / M) * RW + r;
}

// A unit's place in the write order: quarter q of the segment at row r
// of block blk, outbox slot `slot`. It starts from unit u with the only
// divisions and steps one unit at a time.
struct UnitPos {
  int q, r, slot, blk;
  __device__ __forceinline__ UnitPos(int u, int M, int RW) {
    int row;
    segment_coords(u / kUnitsPerSeg, M, RW, &row, &slot);
    q = u % kUnitsPerSeg;
    r = row % RW;
    blk = row / RW;
  }
  __device__ __forceinline__ void next(int M, int RW) {
    if (++q < kUnitsPerSeg) return;
    q = 0;
    if (++r < RW) return;
    r = 0;
    if (++slot < M) return;
    slot = 0;
    ++blk;
  }
  // this thread's node
  __device__ __forceinline__ int node(int RW) const {
    return (blk * RW + r) * kLanes + q * kT + threadIdx.x;
  }
};

// Sum of v over the warp, in every lane.
__device__ __forceinline__ int warp_total(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kFleet, bool kWide>
__global__ void __launch_bounds__(kT, kMinBlocks) fire_compact_kernel(
    const int32_t* __restrict__ pdst, const int32_t* __restrict__ woff_n,
    const int32_t* __restrict__ payload, int n, int M, int P, int RW, int S,
    int Q, int Gw, int jobs, int32_t* __restrict__ wcnt,
    int32_t* __restrict__ ctatot, int32_t* __restrict__ out_dst,
    int32_t* __restrict__ out_woff, int32_t* __restrict__ out_smrank,
    int32_t* __restrict__ out_pay, int32_t* __restrict__ drops) {
  __shared__ int32_t red[kWarps], red2[kWarps];
  // staged words [1 + P][kBatch][kT]: woff, then the payload words
  // (kWide: [1][kBatch][kT], woff alone)
  extern __shared__ int32_t s_w[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;

  // The job in hand: part `part` of world `w`'s Q units (its units u0 ..
  // u0 + nu - 1), with the world's planes, scratch and batch.
  int w = 0, part = 0, u0 = 0, nu = 0;
  const int32_t *pd = pdst, *wo = woff_n, *pl = payload;
  int32_t *wc = wcnt, *od = out_dst, *ow = out_woff, *osm = out_smrank,
          *op = out_pay;
  const auto enter = [&](int job) {
    // solo (kFleet false): world 0, one job a CTA — the offsets fold away
    w = kFleet ? job / Gw : 0;
    part = job - w * Gw;
    u0 = static_cast<int>(static_cast<int64_t>(Q) * part / Gw);
    nu = static_cast<int>(static_cast<int64_t>(Q) * (part + 1) / Gw) - u0;
    const int64_t wmn = static_cast<int64_t>(w) * M * n;
    pd = pdst + wmn;
    wo = woff_n != nullptr ? woff_n + static_cast<int64_t>(w) * n : nullptr;
    pl = payload + wmn * P;
    wc = wcnt + static_cast<int64_t>(w) * Q * kWarps;
    od = out_dst + static_cast<int64_t>(w) * S;
    ow = out_woff + static_cast<int64_t>(w) * S;
    osm = out_smrank + static_cast<int64_t>(w) * S;
    op = out_pay + static_cast<int64_t>(w) * P * S;
  };

  // A lane's dst in units i0 .. i0 + kBatch - 1 (-1 past the units or
  // past n), from position `at`; with `all`, its woff and payload words
  // go to shared memory by asynchronous copy, not waited for here. They
  // do not wait for the dst: at the densities that matter each 32-byte
  // sector of them holds some message, so reading it whole costs no
  // extra sectors.
  const auto stage = [&](int i0, UnitPos at, int* dv, bool all) {
    const int32_t* src[kBatch];  // a lane's payload word 0, or null
#pragma unroll
    for (int i = 0; i < kBatch; ++i, at.next(M, RW)) {
      dv[i] = -1;
      src[i] = nullptr;
      const int node = at.node(RW);
      if (i0 + i >= nu || node >= n) continue;
      dv[i] = pd[static_cast<int64_t>(at.slot) * n + node];
      if (!all) continue;
      if (wo != nullptr) copy_async(&s_w[i * kT + tid], wo + node);
      src[i] = pl + static_cast<int64_t>(at.slot) * P * n + node;
    }
    if constexpr (kWide) return;  // the payload is read in step 3
    if (!all) return;
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (src[i] != nullptr)
          copy_async(&s_w[((1 + p) * kBatch + i) * kT + tid],
                     src[i] + static_cast<int64_t>(p) * n);
  };
  // each warp's valid count in units i0 .. i0 + kBatch - 1, and its sum
  int mine = 0;
  const auto count = [&](int i0, const int* dv) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = __popc(__ballot_sync(0xffffffffu, dv[i] >= 0));
      if (lane == 0 && i0 + i < nu)
        wc[static_cast<int64_t>(u0 + i0 + i) * kWarps + warp] = c;
      mine += c;
    }
  };

  // 1. load and count, job after job (the CTA's first job's first batch
  // kept: dst in registers, the rest staged)
  UnitPos at(0, M, RW);
  int kd[kBatch];
  const auto count_job = [&](int job, bool first) {
    enter(job);
    mine = 0;
    at = UnitPos(u0, M, RW);
    if (first) {
      stage(0, at, kd, true);
      count(0, kd);
    } else {
      int dv[kBatch];
      stage(0, at, dv, false);
      count(0, dv);
    }
    for (int i0 = kBatch; i0 < nu; i0 += kBatch) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) at.next(M, RW);
      int dv[kBatch];
      stage(i0, at, dv, false);
      count(i0, dv);
    }
    if (lane == 0) red[warp] = mine;
    __syncthreads();
    if (tid == 0) {
      int sum = 0;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) sum += red[x];
      ctatot[job] = sum;
    }
    if constexpr (kFleet) __syncthreads();  // red is the next job's
  };
  // the solo instantiation calls each phase once, for its one job, so
  // that the first batch's registers and the world offsets fold away
  if constexpr (kFleet) {
    for (int job = b; job < jobs; job += G) count_job(job, job == b);
  } else {
    count_job(b, true);
  }
  cg::this_grid().sync();

  const unsigned below = (1u << lane) - 1u;
  const auto write_job = [&](int job, bool first) {
    enter(job);
    // 2. this job's write base and its world's fired count: the world's
    // job totals are loaded all at once (kTotals a thread covers every
    // grid the card can hold), then summed over the CTA
    const int32_t* tot = ctatot + static_cast<int64_t>(w) * Gw;
    int before = 0, all = 0;
    {
      int v[kTotals];
#pragma unroll
      for (int i = 0; i < kTotals; ++i)
        v[i] = tid + i * kT < Gw ? tot[tid + i * kT] : 0;
#pragma unroll
      for (int i = 0; i < kTotals; ++i) {
        all += v[i];
        before += tid + i * kT < part ? v[i] : 0;
      }
      for (int c = tid + kTotals * kT; c < Gw; c += kT) {
        const int x = tot[c];
        all += x;
        before += c < part ? x : 0;
      }
    }
    before = warp_total(before);
    all = warp_total(all);
    if (lane == 0) {
      red[warp] = before;
      red2[warp] = all;
    }
    __syncthreads();
    int base = 0;
    all = 0;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      base += red[x];
      all += red2[x];
    }
    if constexpr (kFleet) __syncthreads();  // red, red2: the next job's

    // 3. scatter, unit after unit in write order
    at = UnitPos(u0, M, RW);
    const auto scatter = [&](int i0, const int* dv) {
      int wv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        wv[i] = i0 + i < nu && lane < kWarps
                    ? wc[static_cast<int64_t>(u0 + i0 + i) * kWarps + lane]
                    : 0;
      copy_wait();
      int at_pos[kBatch];  // where a lane's message goes, or -1
      // kWide: a lane's payload word 0 in global memory
      [[maybe_unused]] const int32_t* psrc[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i, at.next(M, RW)) {
        int x = wv[i];  // inclusive scan over the unit's warp counts
#pragma unroll
        for (int o = 1; o < kWarps; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        const int unit_total = __shfl_sync(0xffffffffu, x, kWarps - 1);
        const int warp_base =
            __shfl_sync(0xffffffffu, x, warp > 0 ? warp - 1 : 0);
        const int d = dv[i];
        const unsigned ballot = __ballot_sync(0xffffffffu, d >= 0);
        const int pos = base + (warp > 0 ? warp_base : 0) +
                        __popc(ballot & below);
        at_pos[i] = -1;
        if (d >= 0 && pos < S) {
          const int node = at.node(RW), slot = at.slot;
          od[pos] = d;
          ow[pos] = wo != nullptr ? s_w[i * kT + tid] : 0;
          osm[pos] = node * M + slot;
          at_pos[i] = pos;
          if constexpr (kWide)
            psrc[i] = pl + static_cast<int64_t>(slot) * P * n + node;
        }
        base += unit_total;
      }
      if constexpr (kWide) {
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            if (at_pos[i] >= 0)
              op[static_cast<int64_t>(p) * S + at_pos[i]] =
                  __ldg(psrc[i] + static_cast<int64_t>(p) * n);
      } else {
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            if (at_pos[i] >= 0)
              op[static_cast<int64_t>(p) * S + at_pos[i]] =
                  s_w[((1 + p) * kBatch + i) * kT + tid];
      }
    };
    if (first) {
      scatter(0, kd);
    } else {
      int dv[kBatch];
      stage(0, at, dv, true);
      scatter(0, dv);
    }
    for (int i0 = kBatch; i0 < nu; i0 += kBatch) {
      int dv[kBatch];
      stage(i0, at, dv, true);
      scatter(i0, dv);
    }

    // this job's share of its world's sentinel tail [min(total, S), S)
    const int fired = min(all, S);
    for (int64_t q = fired + static_cast<int64_t>(part) * kT + tid; q < S;
         q += static_cast<int64_t>(Gw) * kT) {
      od[q] = n;
      ow[q] = 0;
      osm[q] = 0;
      for (int p = 0; p < P; ++p) op[static_cast<int64_t>(p) * S + q] = 0;
    }
    if (part == Gw - 1 && tid == 0) drops[w] = all > S ? all - S : 0;
  };
  if constexpr (kFleet) {
    for (int job = b; job < jobs; job += G) write_job(job, job == b);
  } else {
    write_job(b, true);
  }
}

// Dynamic shared memory of a CTA: the staged words.
template <bool kWide>
int staged_bytes(int P) { return (1 + (kWide ? 0 : P)) * kBatch * kT * 4; }

// The most CTAs of fire_compact_kernel<kFleet, kWide> the device holds at
// once with its words staged: queried once per device and P (the narrow
// cache holds every P whose staging fits a CTA; the wide build stages the
// same bytes at every P).
template <bool kFleet, bool kWide>
cudaError_t resident_ctas(int P, int* out) {
  constexpr int kCachedP = 32;
  static int cache[kMaxDevices][kCachedP] = {};
  const int key = kWide ? 0 : P;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices && key < kCachedP;
  if (cached && cache[dev][key] > 0) {
    *out = cache[dev][key];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fire_compact_kernel<kFleet, kWide>, kT,
      staged_bytes<kWide>(P));
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (cached) cache[dev][key] = per_sm * sms;
  *out = per_sm * sms;
  return cudaSuccess;
}

// One cooperative launch of fire_compact_kernel<kFleet, kWide> over B
// worlds.
template <bool kFleet, bool kWide>
cudaError_t launch(const int32_t* pdst, const int32_t* woff_n,
                   const int32_t* payload, int n, int M, int P, int S, int B,
                   int32_t* scratch, int32_t* out_dst, int32_t* out_woff,
                   int32_t* out_smrank, int32_t* out_pay, int32_t* drops,
                   cudaStream_t stream) {
  const int NR = (n + kLanes - 1) / kLanes;
  int RW = NR % 8 == 0 ? 8 : 1;
  int Q = NR * M * kUnitsPerSeg;
  const int smem = staged_bytes<kWide>(P);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {  // above the default cap: opt in, or fail here
    err = cudaFuncSetAttribute(fire_compact_kernel<kFleet, kWide>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  int ctas = 0;
  err = resident_ctas<kFleet, kWide>(P, &ctas);
  if (err != cudaSuccess) return err;
  // Gw jobs (contiguous unit ranges) a world, one job a CTA when the
  // card holds B * Gw CTAs; past that (B above the resident CTAs) a
  // world is one job and a CTA takes several, a grid apart
  int Gw = ctas / B;
  if (Gw < 1) Gw = 1;
  if (Gw > Q) Gw = Q;
  int jobs = B * Gw;
  const int grid = ctas < jobs ? ctas : jobs;
  int32_t* wcnt = scratch;
  int32_t* ctatot = scratch + static_cast<int64_t>(B) * Q * kWarps;
  void* args[] = {&pdst, &woff_n, &payload, &n, &M, &P, &RW, &S, &Q,
                  &Gw, &jobs, &wcnt, &ctatot, &out_dst, &out_woff,
                  &out_smrank, &out_pay, &drops};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&fire_compact_kernel<kFleet, kWide>),
      grid, kT, args, smem, stream);
}

template <bool kWide>
cudaError_t launch_any(const int32_t* pdst, const int32_t* woff_n,
                       const int32_t* payload, int n, int M, int P, int S,
                       int B, int32_t* scratch, int32_t* out_dst,
                       int32_t* out_woff, int32_t* out_smrank,
                       int32_t* out_pay, int32_t* drops,
                       cudaStream_t stream) {
  return B == 1 ? launch<false, kWide>(pdst, woff_n, payload, n, M, P, S, B,
                                       scratch, out_dst, out_woff,
                                       out_smrank, out_pay, drops, stream)
                : launch<true, kWide>(pdst, woff_n, payload, n, M, P, S, B,
                                      scratch, out_dst, out_woff, out_smrank,
                                      out_pay, drops, stream);
}

}  // namespace

extern "C" const char* tw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The widest payload the narrow build stages on the current device: the
// words of a CTA's opt-in shared memory, less the kernel's static shared
// memory, at 8 KB a word, less woff's. Returns the CUDA error (0 = ok).
extern "C" int tw_fire_compact_narrow_max(int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fire_compact_kernel<true, false>);
  if (err != cudaSuccess) return err;
  *out = (optin - static_cast<int>(attr.sharedSizeBytes)) /
             (kBatch * kT * 4) -
         1;
  return cudaSuccess;
}

// B worlds, each laid out as one solo call, world-major: pdst int32[B,
// M, n], woff_n int32[B, n] or null (window 1), payload int32[B, M, P,
// n]; scratch int32[B * units * 9] with units = ceil(n / 1024) * M * 4;
// outputs dst, woff, smrank int32[B, S], pay int32[B, P, S], drops
// int32[B]. One cooperative launch for every world; B = 1 takes the solo
// instantiation, whose world offsets are constants; `wide` (nonzero)
// takes the build that stages woff alone. Returns the launch's CUDA error
// (0 = launched).
extern "C" int tw_fire_compact(const int32_t* pdst, const int32_t* woff_n,
                               const int32_t* payload, int n, int M, int P,
                               int S, int B, int wide, int32_t* scratch,
                               int32_t* out_dst, int32_t* out_woff,
                               int32_t* out_smrank, int32_t* out_pay,
                               int32_t* drops, void* stream) {
  if (B < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch_any<true>(pdst, woff_n, payload, n, M, P, S, B,
                                 scratch, out_dst, out_woff, out_smrank,
                                 out_pay, drops, st)
              : launch_any<false>(pdst, woff_n, payload, n, M, P, S, B,
                                  scratch, out_dst, out_woff, out_smrank,
                                  out_pay, drops, st);
}
