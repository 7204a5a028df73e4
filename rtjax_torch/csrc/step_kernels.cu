// The fused wavefront step for Hopper (sm_90a): route, shade and resolve,
// the kernels of one iteration around one stable key sort (key_sort.cu)
// (kernels/step.py; the lanes' math in step_math.cuh).
//
// Replaces: rtjax/render/wavefront.py wavefront_step (:187-818) -- no
// Pallas kernel but one jitted XLA program, whose per-lane stages XLA
// fuses into a few loops around its lax.sort: route (:212-262 and the key
// and pack half of :263-436), shade with the flush (:437-747) and resolve
// (:748-818).
//
// What bounds them on this card: bytes.  Each lane does some hundreds of
// float operations (shade: two BSDF samples, a light sample, a ray-
// triangle test, a camera ray) against 120-250 bytes of state and random
// words read and written once; at 67 TFLOP/s against 3.35 TB/s the bytes
// take longer.  The counts: route reads a slot's state (81 B) and its word
// (8 B) and writes its key and bundle payload (40 B); shade reads its
// order (8 B), the bundle payload through it (36 B), five words (40 B)
// and writes the next state (57 B), two shadow rays with their radiance
// (2 x 33 B + 24 B) and a flushing lane's pixel; resolve reads the
// radiance, the two channels' radiance, masks and occlusion (40 B) and
// writes the radiance (12 B).
//
// What the design does about it (the record design): one thread a slot;
// every state column read and written as [n] SoA arrays so that loads
// coalesce.  The bundle, the one scattered read (gathered by the sort's
// order), is one 40-byte record a lane, staged in shared memory by route
// and written out coalesced, and read by shade with five read-only 8-byte
// loads: two 32-byte sectors a lane where nine columns touched nine (a
// 48-byte record, 16-byte aligned, made route write 8 bytes a lane more
// for nothing shade reads).  The record carries the hit's material index,
// which route looks up, so shade's dependent chain is the record, then
// the block's shared-memory copy of the materials and lights (staged
// once a block, up to kSmemMaterials / kSmemLights rows; beyond them read
// from global memory).  Shade takes 128-thread blocks (85 registers, 20
// resident warps an SM against 16 at 256; capping registers spilled and
// ran slower), computes the next path ray only for the lanes that
// continue and a camera ray only for the lanes that get one.  The counts
// are reduced in the block (__syncthreads_count) to one 64-bit atomic a
// block.  A lane takes only its material's and its light's branch of the
// plain version's branchless code.  The flush adds only the dirty
// window's lanes (the sorted positions [counts[0], counts[0] +
// counts[4]); every other lane holds no radiance): one float atomicAdd a
// non-zero component, so a frame is not reproducible bit for bit (an
// ordered flush cost more device time than the 3% allowed, PERF.md).
//
// The first design (kV1: the bundle as nine [n] columns, the
// material looked up in shade from global memory, three float atomics a
// dead lane) stays for same-run A/B: rtjax_step_route_v1 /
// rtjax_step_shade_v1.
//
// The full-record modes (kMode in step_math.cuh; kernels/step.py
// MODE_KERNELS): rtjax's unsorted engine (wavefront.py:277 state_sorted
// false, :305 k_sort 1, :630-640 the cumsum rank) and reference_parity
// (:261 limbo, :355-363 the full-state sort, :435 gen_mask, :478 / :498
// the truncated second pdfs, :514-530 the path's own triangle as the
// BSDF-MIS target, :719 the flush over every lane, :791-807 the limbo
// restore and work_left), each on both engines.  Bytes bound them too:
// route reads a slot's state (81 B) and word (8 B) and writes its record
// (88 B of payload, 92 B with parity's camera rank; 4 B of key under
// parity's sort); shade reads the record (the same, through the sort's
// 8-byte order under parity) and five words (40 B) and writes what the
// default shade writes (57 B, 90 B of shadow rays) and the limbo flag
// (1 B); route and shade merged read the
// state and five words (121 B) and write shade's outputs; resolve adds,
// for a limbo lane, its order and 24 B of its record read and 21 B of hit
// written.  The design: the record is the 12 fields rtjax's parity sort
// carries (pixel, ray origin and direction, t, normal, prim, src,
// bounces, throughput, radiance, the mat and limbo flags) and the
// material index,
// at full precision, laid out as six 16-byte words a lane (96 B, three
// 32-byte sectors: ray_o|t, ray_d|pixel, normal|prim, beta|src,
// acc|bounces, flags|material|0|0), staged by route in shared memory and
// written out coalesced, read by shade with six 16-byte loads.  The lanes
// that take a camera ray are not a suffix (unsorted, or limbo lanes among
// the dead), so they go by their exclusive rank among such lanes.  Under
// parity route takes it in slot order (the parity sort keeps these lanes
// in slot order: step_math.cuh rank_*) by a look-back over its blocks,
// which take their indices from a ticket on a persistent scratch that no
// launch zeroes, and carries it in the record's word 22; shade reads it
// with the record and has no scan, no barrier between the record's load
// and the shading and no reset (route_ranked, shade_ranked): on the
// parity frame's state at 2^19 lanes shade took 0.0729-0.0740 ms against
// the first design's 0.1141-0.1151 ms in turns, at 94 registers and 20
// resident warps an SM against 104 and 16, and route 0.0492 against
// 0.0435-0.0438 ms (NVIDIA H100 80GB HBM3, 700.00 W; tools/step_designs.py
// --variants, PERF.md).  Every such lane flushes its non-zero radiance by
// float atomics.  On the unsorted engine without parity route and shade
// are one kernel (route_shade_unsorted: route's lanes in registers, no
// record): on the headline's state under "xla" PR 18's merged kernel took
// 0.0706-0.0712 ms against 0.0906-0.0907 ms for the two kernels in turns
// (NVIDIA H100 80GB HBM3, 700.00 W; tools/mode_steps.py --split-ab,
// PERF.md).  There the lanes that take a camera ray are the ones that do
// not continue, which shade no path ray and read their rank only to make
// their camera ray, so the kernel publishes each block's count of them
// as soon as it has routed, shades, and only then takes the block's prefix
// by the warp's look-back on a scratch of its own block count (route_shade
// below): no block waits before it shades.  The first designs of both
// (route_parity_v1, shade_parity_v1 and their unsorted instances;
// route_shade_unsorted_v1 and _1s_v1; kept for timing in turns) ranked in
// shade by a single-pass scan with decoupled look-back before the
// shading, thread 0 walking back, the block that finished last zeroing
// it for the next launch (shade_full).  Parity on the unsorted engine
// keeps two kernels: its resolve restores limbo lanes from the record.
//
// The sorted engine's wide bundle (kWide: wavefront.py:418-432, past the
// compact bundle's ranges; :305 k_sort 1) is the default estimator over
// the full record: route_wide keys with the dirty class, as route does,
// and stores the hit point in the record's origin words (the
// alternative, recomputing it from ray_o, t and the mat bit after the
// gather, is bit for bit the same but reads t); bounces and the mat bit
// go through the op-by-op step's one packed word (15 bits, 0x7FFF dead);
// src keeps its int32 word.  shade_wide gathers the record by the sort's
// order with shade's code: the camera rays go to the dead suffix, no
// scan, and the flush comes from the dirty window.  Bytes: route_wide as
// route_parity (181 B a lane); shade_wide reads 84 B of record (no t),
// its order and five words and writes what shade writes.
//
// One-sample MIS (kOneSample: :486-508, :758-773): shade reuses the path
// sample for the BSDF-MIS channel, reads no W_BSDF2 word and writes N
// shadow rays (the NEE ones) with the channel's mask and radiance (zero
// off the mask); resolve adds the channel where the path ray's closest
// hit is the picked light's triangle, after the NEE channel, as
// rtjax's _accum order.  Instances: shade_1s, route_shade_unsorted_1s,
// shade_wide_1s, resolve_1s.  The sorted engine's shade_1s moves 15-16
// us of bytes at 2^18 lanes but ran at half of that bound in the default
// shade's design (one thread a position, 2,048 blocks of 128), which
// waits out each position's chain alone: its order word, then its record
// through it, then a few hundred instructions of math, then its stores;
// 24 warps an SM do not cover two dependent reads of device memory.  So
// shade_1s is a resident grid whose threads pipeline their chains
// (step_math.cuh shade_1s_walk: while a thread shades tile k, its record
// and words of tile k + 1 and its order word of tile k + 2 are in flight,
// cp.async into shared memory), with the tables staged once a block and
// the counts added once a block.  The lane math is shade_lane's
// (shade_math), so the outputs are the plain version's bit for bit as
// before; the first design stays as shade_1s_v1.
//
// detailed_stats (kStats: :809-815): resolve adds each traced lane to the
// bounce histogram at clamp(bounces, 0, max_bounces): resolve_stats,
// resolve_1s_stats, resolve_parity_stats.  The first design (hist_block,
// kept as resolve_parity_stats_v1) counted a block's lanes with a shared
// atomic a lane between two barriers and added the block's bins to the
// histogram before the lane's own work, so that each block waited out
// the bins' loads, then the histogram's atomics, then its lane loads.
// Now the histogram goes around the lane's work (hist_begin / hist_end):
// the bins' loads fly beside the lane's, and each traced lane adds to the
// block's shared-memory bins and the block adds its non-zero bins to the
// histogram after the lane's work.  Warp votes on the bins and meeting the
// bins of a thread-block cluster in its leader's shared memory were built
// and measured no faster (PERF.md §6, rows 16s-16ps).  The four traversal
// sums stay four adds in render/wavefront.py, as the op-by-op step makes
// them (not folded into resolve).  The flags are
// template parameters beside kMode; each compiles out of the other
// instances, whose ptxas registers are unchanged (chip_smoke.py
// STEP_REGISTERS).

#include <algorithm>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

using rtjax_step::StepArgs;
using rtjax_step::Tables;

constexpr int kBlock = 256;
constexpr int kShadeBlock = 128;
constexpr int kSmemMaterials = 256;
constexpr int kSmemLights = 64;
constexpr int kRecordWords = 10;  // kernels/step.py BUNDLE_ROWS
constexpr int kRouteBlocks = 6;
// histogram bins a resolve block counts in shared memory (detailed_stats;
// beyond them each traced lane adds to the histogram in global memory)
constexpr int kSmemBins = 4096;
// resolve's bounce histogram (detailed_stats): none, around the lane's
// work (hist_begin / hist_end), or before it as the first design
// (hist_block)
constexpr int kNoHist = 0, kHistAround = 1, kHistBlock = 2;
using rtjax_step::kFullWords;
static_assert(kShadeBlock == rtjax_step::kScanBlock,
              "a shade block ranks kScanBlock lanes");
static_assert(kBlock == rtjax_step::kRankBlock,
              "a parity route block ranks kRankBlock slots");

// a release and acquire fence at the card's scope: all that the scan's
// reset needs (__threadfence is the sequentially consistent fence.sc.gpu)
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void count(long long* c, bool pred) {
  const int k = __syncthreads_count(pred);
  if (threadIdx.x == 0 && k != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(c),
              static_cast<unsigned long long>(k));
}

// the record design's route, at least kRouteBlocks blocks an SM (40
// registers, 48 warps an SM, as the first design's)
__global__ void __launch_bounds__(kBlock, kRouteBlocks)
    route_kernel(const StepArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  rtjax_step::RouteLane r = {false, false};
  // the block's records, contiguous in the bundle, staged here and
  // written out 16 coalesced bytes a thread (a last, partial block, 4)
  __shared__ int4 rec[kRecordWords * kBlock / 4];
  if (i < a.n)
    r = rtjax_step::route_lane<false>(
        a, i, reinterpret_cast<int2*>(rec) + 5 * threadIdx.x);
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kBlock;
  const long long left = a.n - first;
  if (left >= kBlock) {
    int4* out = reinterpret_cast<int4*>(a.bundle + kRecordWords * first);
    for (int t = threadIdx.x; t < kRecordWords * kBlock / 4; t += kBlock)
      out[t] = rec[t];
  } else {
    const int* in = reinterpret_cast<const int*>(rec);
    for (int t = threadIdx.x; t < kRecordWords * left; t += kBlock)
      a.bundle[kRecordWords * first + t] = in[t];
  }
  count(a.counts, r.mat);
  count(a.counts + 4, r.dirty);
}

// the full-record modes' route: the block's 96-byte records staged in
// shared memory and written out 16 coalesced bytes a thread
template <int kMode>
__device__ __forceinline__ void route_full(const StepArgs& a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  rtjax_step::RouteLane r = {false, false, false};
  __shared__ int4 rec[kFullWords * kBlock / 4];
  if (i < a.n)
    r = rtjax_step::route_lane<false, kMode>(
        a, i, reinterpret_cast<int2*>(rec) + kFullWords / 2 * threadIdx.x);
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kBlock;
  const long long left = a.n - first;
  if (left >= kBlock) {
    int4* out = reinterpret_cast<int4*>(a.bundle + kFullWords * first);
    for (int t = threadIdx.x; t < kFullWords * kBlock / 4; t += kBlock)
      out[t] = rec[t];
  } else {
    const int* in = reinterpret_cast<const int*>(rec);
    for (int t = threadIdx.x; t < kFullWords * left; t += kBlock)
      a.bundle[kFullWords * first + t] = in[t];
  }
  count(a.counts, r.mat);
  count(a.counts + 4, kMode == rtjax_step::kWide ? r.dirty : r.limbo);
}

__global__ void __launch_bounds__(kBlock)
    route_wide_kernel(const StepArgs a) {
  route_full<rtjax_step::kWide>(a);
}

__global__ void __launch_bounds__(kBlock)
    route_parity_v1_kernel(const StepArgs a) {
  route_full<rtjax_step::kParity>(a);
}

__global__ void __launch_bounds__(kBlock)
    route_parity_unsorted_v1_kernel(const StepArgs a) {
  route_full<rtjax_step::kParityUnsorted>(a);
}

__device__ __forceinline__ unsigned rank_load(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// block b's count ``total`` of lanes that take a camera ray published (block
// 0: as its inclusive prefix), by one thread
__device__ __forceinline__ void rank_publish(unsigned* status, int b,
                                             unsigned total,
                                             unsigned parity) {
  atomicExch(status + b, rtjax_step::rank_word(parity, b == 0, total));
}

// block b's exclusive camera rank over the blocks before it, by one warp
// (``lane`` its lane), after rank_publish: the status words walked back
// kRankLook at a time, a lane a word (a block before the first reads as a
// published prefix of 0), and the inclusive prefix published
// (step_math.cuh rank_*)
__device__ __forceinline__ unsigned rank_lookback(unsigned* status, int b,
                                                  unsigned total,
                                                  unsigned parity, int lane) {
  using namespace rtjax_step;
  if (b == 0) return 0;
  unsigned before = 0;
  for (int j = b - 1;;) {
    const unsigned w = j - lane >= 0 ? rank_load(status + j - lane)
                                     : rank_word(parity, true, 0);
    const bool pub = rank_published(w, parity);
    const RankStep s = rank_step(__ballot_sync(0xFFFFFFFFu, !pub),
                                 __ballot_sync(0xFFFFFFFFu,
                                               pub && (w & kRankPrefix)));
    before += __reduce_add_sync(
        0xFFFFFFFFu, ((s.take >> lane) & 1u) ? (w & kRankValue) : 0u);
    if (s.back < 0) break;
    j -= s.back;
  }
  if (lane == 0)
    atomicExch(status + b, rank_word(parity, true, before + total));
  return before;
}

// the parity modes' route: route_full's records with each lane's camera
// rank in word 22.  The block takes its slots from its ticket (so it waits
// only on blocks that already run) and counts by warp ballots the lanes
// that take a camera ray, the continuing and the limbo lanes, each lane's
// rank within its warp staged in its record; warp 0 takes the block's
// prefix by the look-back (a scratch a size: a.scan, kernels/step.py
// rank_scratch) and adds the counts; the records go out with each warp's
// start added to their rank words: three barriers
template <int kMode>
__device__ __forceinline__ void route_ranked(const StepArgs& a) {
  using namespace rtjax_step;
  constexpr int kWarps = kBlock / 32;
  __shared__ unsigned ticket;
  // the warps' lanes that take a camera ray, continue, are in limbo
  __shared__ int warp_count[3][kWarps];
  __shared__ int warp_start[kWarps];
  __shared__ int4 rec[kFullWords * kBlock / 4];
  auto* scratch = reinterpret_cast<unsigned*>(a.scan);
  const int blocks = static_cast<int>(gridDim.x);
  if (threadIdx.x == 0) ticket = atomicInc(scratch, rank_ticket_limit(blocks));
  __syncthreads();
  const unsigned parity = rank_parity(ticket, blocks);
  const int b = rank_block(ticket, blocks);
  const int i = b * kBlock + threadIdx.x;
  int* words = reinterpret_cast<int*>(rec) + kFullWords * threadIdx.x;
  RouteLane r = {false, false, false};
  if (i < a.n)
    r = route_lane<false, kMode>(a, i, reinterpret_cast<int2*>(words));
  const unsigned gen =
      __ballot_sync(0xFFFFFFFFu, i < a.n && !r.mat && !r.limbo);
  const unsigned mat = __ballot_sync(0xFFFFFFFFu, r.mat);
  const unsigned limbo = __ballot_sync(0xFFFFFFFFu, r.limbo);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_count[0][warp] = __popc(gen);
    warp_count[1][warp] = __popc(mat);
    warp_count[2][warp] = __popc(limbo);
  }
  words[22] = __popc(gen & ((1u << lane) - 1u));
  __syncthreads();
  if (warp == 0) {
    int start = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[0][w];
      if (w < lane) start += c;
      total += c;
    }
    if (lane == 0) rank_publish(scratch + 1, b, total, parity);
    const unsigned p = rank_lookback(scratch + 1, b, total, parity, lane);
    if (lane < kWarps) warp_start[lane] = static_cast<int>(p) + start;
    if (lane < 2) {
      int k = 0;
      for (int w = 0; w < kWarps; ++w) k += warp_count[1 + lane][w];
      if (k != 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.counts + 4 * lane),
                  static_cast<unsigned long long>(k));
    }
  }
  __syncthreads();
  const long long first = static_cast<long long>(b) * kBlock;
  const long long left = a.n - first;
  if (left >= kBlock) {
    int4* out = reinterpret_cast<int4*>(a.bundle + kFullWords * first);
    for (int t = threadIdx.x; t < kFullWords * kBlock / 4; t += kBlock) {
      int4 v = rec[t];
      if (t % (kFullWords / 4) == 22 / 4)
        v.z += warp_start[t / (kFullWords / 4) / 32];
      out[t] = v;
    }
  } else {
    const int* in = reinterpret_cast<const int*>(rec);
    for (int t = threadIdx.x; t < kFullWords * left; t += kBlock)
      a.bundle[kFullWords * first + t] =
          in[t] + (t % kFullWords == 22 ? warp_start[t / kFullWords / 32]
                                        : 0);
  }
}

__global__ void __launch_bounds__(kBlock)
    route_parity_kernel(const StepArgs a) {
  route_ranked<rtjax_step::kParity>(a);
}

__global__ void __launch_bounds__(kBlock)
    route_parity_unsorted_kernel(const StepArgs a) {
  route_ranked<rtjax_step::kParityUnsorted>(a);
}

__global__ void __launch_bounds__(kBlock) route_v1_kernel(const StepArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  rtjax_step::RouteLane r = {false, false};
  if (i < a.n) r = rtjax_step::route_lane<true>(a, i, nullptr);
  count(a.counts, r.mat);
  count(a.counts + 4, r.dirty);
}

// the block's copy of the materials and the light rows
struct SmemTables {
  int mtype[kSmemMaterials];
  float albedo[3 * kSmemMaterials];
  float ior[kSmemMaterials];
  int ltype[kSmemLights];
  int ltri[kSmemLights];
  float rows[6][3 * kSmemLights];  // lpos, lemit, ltp0, lte1, lte2, ltn
};

// stage the tables that fit into shared memory (all threads of the block
// call it); the others stay in global memory
__device__ __forceinline__ Tables stage_tables(const StepArgs& a,
                                               SmemTables& s) {
  Tables T = rtjax_step::global_tables(a);
  const bool mats = a.num_materials <= kSmemMaterials;
  const bool lights = a.num_light_rows <= kSmemLights;
  if (mats) {
    for (int k = threadIdx.x; k < a.num_materials; k += blockDim.x) {
      s.mtype[k] = a.mtype[k];
      s.ior[k] = a.ior[k];
      for (int c = 0; c < 3; ++c) s.albedo[3 * k + c] = a.albedo[3 * k + c];
    }
  }
  if (lights) {
    for (int k = threadIdx.x; k < a.num_light_rows; k += blockDim.x) {
      s.ltype[k] = a.ltype[k];
      s.ltri[k] = a.ltri[k];
    }
    for (int k = threadIdx.x; k < 3 * a.num_light_rows; k += blockDim.x) {
      s.rows[0][k] = a.lpos[k];
      s.rows[1][k] = a.lemit[k];
      s.rows[2][k] = a.ltp0[k];
      s.rows[3][k] = a.lte1[k];
      s.rows[4][k] = a.lte2[k];
      s.rows[5][k] = a.ltn[k];
    }
  }
  __syncthreads();
  if (mats) {
    T.mtype = s.mtype;
    T.albedo = s.albedo;
    T.ior = s.ior;
  }
  if (lights) {
    T.ltype = s.ltype;
    T.ltri = s.ltri;
    T.lpos = s.rows[0];
    T.lemit = s.rows[1];
    T.ltp0 = s.rows[2];
    T.lte1 = s.rows[3];
    T.lte2 = s.rows[4];
    T.ltn = s.rows[5];
  }
  return T;
}

// a lane's non-zero radiance added to its pixel, one float atomic a
// component
__device__ __forceinline__ void flush(const StepArgs& a,
                                      const rtjax_step::ShadeLane& s) {
  const rtjax_step::V3 v = s.flushed;
  float* px = a.fb + 3 * static_cast<long long>(s.pixel);
  if (v.x != 0.0f) atomicAdd(px, v.x);
  if (v.y != 0.0f) atomicAdd(px + 1, v.y);
  if (v.z != 0.0f) atomicAdd(px + 2, v.z);
}

// the sorted engine's shade: the record design's compact record (kMode
// kDefault) or the wide bundle's full record (kWide, sort_every 1), both
// flushed from the dirty window
template <int kMode, bool kOneSample>
__device__ __forceinline__ void shade_sorted(const StepArgs& a) {
  __shared__ SmemTables smem;
  const Tables T = stage_tables(a, smem);
  const int i = blockIdx.x * kShadeBlock + threadIdx.x;
  const bool do_gen = rtjax_step::cadence(a);
  rtjax_step::ShadeLane r = {};
  if (i < a.n) {
    r = rtjax_step::shade_lane<false, kMode, kOneSample>(a, i, T, do_gen);
    const long long lo = a.counts[0];
    if (r.flush && i >= lo && i < lo + a.counts[4]) flush(a, r);
  }
  count(a.counts + 1, r.trace);
  count(a.counts + 2, r.nee);
  count(a.counts + 3, r.mis);
}

// at least one block an SM: ptxas then takes 85 registers, not 84, and
// the kernel runs 10% faster (PERF.md)
__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_kernel(const StepArgs a) {
  shade_sorted<rtjax_step::kDefault, false>(a);
}

// the first design of the one-sample shade (kept for timing in turns):
// one thread a sorted position, its chain of loads waited out alone
__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_1s_v1_kernel(const StepArgs a) {
  shade_sorted<rtjax_step::kDefault, true>(a);
}

// the sorted engine's one-sample shade: a resident grid (launch_resident), the
// scene's tables staged once a block, each thread walking its positions of
// the block's tiles with its loads pipelined (step_math.cuh
// shade_1s_walk), the flush from the dirty window, and the block's counts
// of traced, NEE and MIS lanes added with one 64-bit atomic each at the end
__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_1s_kernel(const StepArgs a) {
  using namespace rtjax_step;
  static_assert(kShadeTile == kShadeBlock, "a tile is a block's threads");
  __shared__ SmemTables smem;
  __shared__ ShadeStages stages;
  __shared__ int warp_count[3][kShadeBlock / 32];
  const Tables T = stage_tables(a, smem);
  const bool do_gen = cadence(a);
  const long long lo = a.counts[0], hi = lo + a.counts[4];
  const WalkCounts c = shade_1s_walk(
      a, T, stages, threadIdx.x, blockIdx.x, gridDim.x, do_gen,
      [&](long long i, const ShadeLane& r) {
        if (r.flush && i >= lo && i < hi) flush(a, r);
      });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned trace = __reduce_add_sync(0xFFFFFFFFu, c.trace);
  const unsigned nee = __reduce_add_sync(0xFFFFFFFFu, c.nee);
  const unsigned mis = __reduce_add_sync(0xFFFFFFFFu, c.mis);
  if (lane == 0) {
    warp_count[0][warp] = static_cast<int>(trace);
    warp_count[1][warp] = static_cast<int>(nee);
    warp_count[2][warp] = static_cast<int>(mis);
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    long long k = 0;
    for (int w = 0; w < kShadeBlock / 32; ++w) k += warp_count[threadIdx.x][w];
    if (k != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.counts + 1 +
                                                      threadIdx.x),
                static_cast<unsigned long long>(k));
  }
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_wide_kernel(const StepArgs a) {
  shade_sorted<rtjax_step::kWide, false>(a);
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_wide_1s_kernel(const StepArgs a) {
  shade_sorted<rtjax_step::kWide, true>(a);
}

// the first designs' shade, which ranks the camera rays itself before it
// shades (the unsorted engine's route_shade_unsorted_v1 and _1s_v1, the
// parity modes' shade_parity_v1 and its unsorted instance): the block's
// index from the scan's ticket, each lane's record gathered (by the sort's
// order under kParity; on the unsorted engine without parity, route's
// record made in registers and the continuing paths counted here: route
// and shade in one kernel), the block's lanes that take a camera ray
// counted by warp ballots and ranked by the look-back scan
// (step_math.cuh scan_*), then the lanes shaded; every such lane's
// non-zero radiance flushed by float atomics.  The block that finishes
// its look-back last zeroes the scan buffer for the next launch
// (kernels/step.py scan_buffer).
template <int kMode, bool kOneSample = false>
__device__ __forceinline__ void shade_full(const StepArgs& a) {
  __shared__ SmemTables smem;
  __shared__ int block;
  __shared__ int warp_count[kShadeBlock / 32];
  __shared__ long long prefix;
  __shared__ bool last;
  auto* scan = reinterpret_cast<unsigned long long*>(a.scan);
  unsigned long long* status = scan + 2;
  if (threadIdx.x == 0)
    block = static_cast<int>(atomicAdd(scan, 1ULL));
  const Tables T = stage_tables(a, smem);  // its barrier publishes block
  const int b = block;
  const int i = b * kShadeBlock + threadIdx.x;
  rtjax_step::FullRec r = {};
  bool gen = false;
  if (i < a.n) {
    if constexpr (kMode == rtjax_step::kUnsorted) {
      int2 w[kFullWords / 2];
      rtjax_step::route_lane<false, kMode>(a, i, w);
      r = rtjax_step::full_from_words(w);
    } else {
      r = rtjax_step::load_full(
          a, (kMode & rtjax_step::kUnsorted) != 0 ? i : a.order[i]);
    }
    gen = !r.mat && !r.limbo;
  }
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, gen);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u)), total = 0;
  for (int w = 0; w < kShadeBlock / 32; ++w) {
    total += warp_count[w];
    if (w < warp) before += warp_count[w];
  }
  if (threadIdx.x == 0) {
    rtjax_step::scan_publish(status, b, total);
    prefix = rtjax_step::scan_lookback(status, b, total);
    // every block that counts itself here has read all it will read; the
    // release fence orders its status words before its count
    fence_acq_rel();
    last = atomicAdd(scan + 1, 1ULL) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    // and the acquire fence orders every block's status words before the
    // reset
    fence_acq_rel();
    for (int w = threadIdx.x; w < static_cast<int>(gridDim.x);
         w += kShadeBlock)
      status[w] = 0;
    if (threadIdx.x == 0) scan[0] = scan[1] = 0;
  }
  rtjax_step::ShadeLane s = {};
  if (i < a.n) {
    s = rtjax_step::shade_full_lane<kMode, kOneSample>(a, i, T, r,
                                                     prefix + before);
    if (s.flush) flush(a, s);
  }
  if constexpr (kMode == rtjax_step::kUnsorted) count(a.counts, r.mat);
  count(a.counts + 1, s.trace);
  count(a.counts + 2, s.nee);
  count(a.counts + 3, s.mis);
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    route_shade_unsorted_v1_kernel(const StepArgs a) {
  shade_full<rtjax_step::kUnsorted>(a);
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    route_shade_unsorted_1s_v1_kernel(const StepArgs a) {
  shade_full<rtjax_step::kUnsorted, true>(a);
}

// the unsorted engine's route and shade in one kernel, its camera rank
// taken after the shading.  A lane that takes a camera ray (one that does
// not continue: the engine has no limbo) needs only its rank, which no
// other lane reads; the others never read it.  So a block takes its index
// from a ticket on the rank's persistent scratch (a.scan, kernels/step.py
// rank_scratch, a scratch a block count, never zeroed: step_math.cuh
// rank_*), routes its lanes into registers, counts those that take a
// camera ray (a barrier) and publishes the count at once; then it shades:
// every lane's shadow rays and flush and the continuing lanes' next path
// rays and state.  Only then does warp 0 take the block's prefix by the
// look-back (rank_lookback) and publish its own; after one barrier the
// camera lanes make their rays by rank, their records' ray, throughput
// and pixel the only state held across it.  Forward progress: a block
// publishes its count before it waits on anything, and it waits only on
// blocks with lower tickets, which already run.  The look-back's latency
// overlaps the block's own shading and that of every other block on the
// SM.  The counts go out as one 64-bit atomic each a block (the traced
// lanes: the continuing ones and the camera rays the block's prefix
// leaves before the frame's end).  Three barriers
template <bool kOneSample>
__device__ __forceinline__ void route_shade(const StepArgs& a) {
  using namespace rtjax_step;
  constexpr int kWarps = kShadeBlock / 32;
  __shared__ SmemTables smem;
  __shared__ unsigned ticket, prefix;
  // each warp's lanes that take a camera ray, send a NEE ray, an MIS ray
  __shared__ int warp_count[3][kWarps];
  auto* scratch = reinterpret_cast<unsigned*>(a.scan);
  const int blocks = static_cast<int>(gridDim.x);
  if (threadIdx.x == 0) ticket = atomicInc(scratch, rank_ticket_limit(blocks));
  const Tables T = stage_tables(a, smem);  // its barrier publishes ticket
  const unsigned parity = rank_parity(ticket, blocks);
  const int b = rank_block(ticket, blocks);
  const int i = b * kShadeBlock + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FullRec r = {};
  if (i < a.n) {
    int2 w[kFullWords / 2];
    route_lane<false, kUnsorted>(a, i, w);
    r = full_from_words(w);
  }
  const bool gen = i < a.n && !r.mat;
  const unsigned cams = __ballot_sync(0xFFFFFFFFu, gen);
  if (lane == 0) warp_count[0][warp] = __popc(cams);
  const int total = __syncthreads_count(gen);
  if (threadIdx.x == 0) rank_publish(scratch + 1, b, total, parity);
  FullShade f = {};
  if (i < a.n) {
    f = shade_full_math<kUnsorted, kOneSample>(a, i, T, r);
    if (gen)
      flush(a, f.s);
    else
      store_full<kUnsorted>(a, i, r, f, CameraRay{});
  }
  const unsigned nee = __ballot_sync(0xFFFFFFFFu, f.s.nee);
  const unsigned mis = __ballot_sync(0xFFFFFFFFu, f.s.mis);
  if (lane == 0) {
    warp_count[1][warp] = __popc(nee);
    warp_count[2][warp] = __popc(mis);
  }
  if (warp == 0) {
    const unsigned p = rank_lookback(scratch + 1, b, total, parity, lane);
    if (lane == 0) prefix = p;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int valid = min(kShadeBlock, a.n - b * kShadeBlock);
    long long k = 0;
    if (threadIdx.x == 0) {
      k = valid - total;
    } else if (threadIdx.x == 1) {
      k = traced_lanes(a, valid, total, prefix);
    } else {
      for (int w = 0; w < kWarps; ++w) k += warp_count[threadIdx.x - 1][w];
    }
    if (k != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.counts + threadIdx.x),
                static_cast<unsigned long long>(k));
  }
  if (gen) {
    int before = __popc(cams & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) before += warp_count[0][w];
    store_full<kUnsorted>(a, i, r, FullShade{},
                          camera_full(a, i, prefix + before));
  }
}

// at least five blocks an SM (20 warps): ptxas then takes 93 registers,
// not 101, and a launch ran 2-7% faster in turns (the one-sample instance
// takes 96 either way; tools/step_designs.py --variants, PERF.md)
__global__ void __launch_bounds__(kShadeBlock, 5)
    route_shade_unsorted_kernel(const StepArgs a) {
  route_shade<false>(a);
}

__global__ void __launch_bounds__(kShadeBlock, 5)
    route_shade_unsorted_1s_kernel(const StepArgs a) {
  route_shade<true>(a);
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_parity_v1_kernel(const StepArgs a) {
  shade_full<rtjax_step::kParity>(a);
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_parity_unsorted_v1_kernel(const StepArgs a) {
  shade_full<rtjax_step::kParityUnsorted>(a);
}

// the parity modes' shade: each lane's record (by the sort's order under
// kParity) with the camera rank route put in it, so that no block waits
// on another and nothing stands between the record's load and the
// shading; every lane that takes a camera ray flushes
template <int kMode>
__device__ __forceinline__ void shade_ranked(const StepArgs& a) {
  __shared__ SmemTables smem;
  const Tables T = stage_tables(a, smem);
  const int i = blockIdx.x * kShadeBlock + threadIdx.x;
  rtjax_step::ShadeLane s = {};
  if (i < a.n) {
    const rtjax_step::FullRec r = rtjax_step::load_full(
        a, (kMode & rtjax_step::kUnsorted) != 0 ? i : a.order[i]);
    s = rtjax_step::shade_full_lane<kMode>(a, i, T, r, r.rank);
    if (s.flush) flush(a, s);
  }
  count(a.counts + 1, s.trace);
  count(a.counts + 2, s.nee);
  count(a.counts + 3, s.mis);
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_parity_kernel(const StepArgs a) {
  shade_ranked<rtjax_step::kParity>(a);
}

__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_parity_unsorted_kernel(const StepArgs a) {
  shade_ranked<rtjax_step::kParityUnsorted>(a);
}

__global__ void __launch_bounds__(kBlock) shade_v1_kernel(const StepArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  rtjax_step::ShadeLane r = {};
  if (i < a.n) {
    r = rtjax_step::shade_lane<true>(a, i, rtjax_step::global_tables(a),
                                     rtjax_step::cadence(a));
    if (r.flush) {
      float* px = a.fb + 3 * static_cast<long long>(r.pixel);
      atomicAdd(px, r.flushed.x);
      atomicAdd(px + 1, r.flushed.y);
      atomicAdd(px + 2, r.flushed.z);
    }
  }
  count(a.counts + 1, r.trace);
  count(a.counts + 2, r.nee);
  count(a.counts + 3, r.mis);
}

// detailed_stats' bounce histogram, the first design: each block counts
// its traced lanes' bins in shared memory (max_bounces + 1 ints, at most
// kSmemBins; sized at launch) with one shared atomic a lane and adds each
// non-zero bin to the histogram with one 64-bit atomic
__device__ __forceinline__ void hist_block(const StepArgs& a, int i) {
  extern __shared__ int bins[];
  const int nb = a.max_bounces + 1;
  const bool staged = nb <= kSmemBins;
  auto* hist = reinterpret_cast<unsigned long long*>(a.hist);
  if (staged)
    for (int k = threadIdx.x; k < nb; k += kBlock) bins[k] = 0;
  __syncthreads();
  const int b = i < a.n ? rtjax_step::hist_bin(a, i) : -1;
  if (b >= 0) {
    if (staged)
      atomicAdd(bins + b, 1);
    else
      atomicAdd(hist + b, 1ULL);
  }
  __syncthreads();
  if (staged)
    for (int k = threadIdx.x; k < nb; k += kBlock)
      if (bins[k] != 0)
        atomicAdd(hist + k, static_cast<unsigned long long>(bins[k]));
}

// detailed_stats' bounce histogram, in two parts around the lane's own
// work, so that its barriers stand behind no load: hist_begin takes the
// lane's bin (its loads in flight beside the lane's) and zeroes the
// block's shared-memory bins (max_bounces + 1 ints, at most kSmemBins;
// sized at launch) behind one barrier; hist_end adds each traced lane to
// its bin with one shared atomic, then after the block's barrier adds the
// non-zero bins to the histogram with one 64-bit atomic each.  Past
// kSmemBins bins each traced lane adds to the histogram in global memory,
// as the first design does
__device__ __forceinline__ int hist_begin(const StepArgs& a, int i) {
  extern __shared__ int bins[];
  const int nb = a.max_bounces + 1;
  const int b = i < a.n ? rtjax_step::hist_bin(a, i) : -1;
  if (nb <= kSmemBins) {
    for (int k = threadIdx.x; k < nb; k += kBlock) bins[k] = 0;
    __syncthreads();
  }
  return b;
}

__device__ __forceinline__ void hist_end(const StepArgs& a, int b) {
  extern __shared__ int bins[];
  const int nb = a.max_bounces + 1;
  auto* hist = reinterpret_cast<unsigned long long*>(a.hist);
  if (nb > kSmemBins) {
    if (b >= 0) atomicAdd(hist + b, 1ULL);
    return;
  }
  if (b >= 0) atomicAdd(bins + b, 1);
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += kBlock)
    if (bins[k] != 0)
      atomicAdd(hist + k, static_cast<unsigned long long>(bins[k]));
}

// resolve: the shadow results, on the default resolve or, with
// kRestore, the parity modes' (each limbo lane's payload restored into
// the closest hits); under one-sample MIS (kOneSample) and detailed_stats
// (kStats: the bounce histogram, hist_begin / hist_end around the lane's
// work, or before it the first design's hist_block)
template <bool kRestore, bool kOneSample, int kStats>
__device__ __forceinline__ void resolve_flags(const StepArgs& a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if constexpr (kStats == kHistBlock) hist_block(a, i);
  int b = -1;
  if constexpr (kStats == kHistAround) b = hist_begin(a, i);
  if (i < a.n) {
    if (a.num_lights > 0) rtjax_step::resolve_lane<kOneSample>(a, i);
    if constexpr (kRestore) rtjax_step::restore_limbo(a, i);
  }
  if constexpr (kStats == kHistAround) hist_end(a, b);
  if (i == 0)
    rtjax_step::resolve_counters<kRestore ? rtjax_step::kParity
                                          : rtjax_step::kDefault>(a);
}

__global__ void __launch_bounds__(kBlock) resolve_kernel(const StepArgs a) {
  resolve_flags<false, false, kNoHist>(a);
}

__global__ void __launch_bounds__(kBlock)
    resolve_parity_kernel(const StepArgs a) {
  resolve_flags<true, false, kNoHist>(a);
}

__global__ void __launch_bounds__(kBlock)
    resolve_1s_kernel(const StepArgs a) {
  resolve_flags<false, true, kNoHist>(a);
}

__global__ void __launch_bounds__(kBlock)
    resolve_stats_kernel(const StepArgs a) {
  resolve_flags<false, false, kHistAround>(a);
}

__global__ void __launch_bounds__(kBlock)
    resolve_1s_stats_kernel(const StepArgs a) {
  resolve_flags<false, true, kHistAround>(a);
}

__global__ void __launch_bounds__(kBlock)
    resolve_parity_stats_kernel(const StepArgs a) {
  resolve_flags<true, false, kHistAround>(a);
}

// the first design of the stats resolve (kept for timing in turns)
__global__ void __launch_bounds__(kBlock)
    resolve_parity_stats_v1_kernel(const StepArgs a) {
  resolve_flags<true, false, kHistBlock>(a);
}

int grid_of(int n, int block) { return (n + block - 1) / block; }

// the dynamic shared memory of a launch: a resolve block's histogram
// bins under detailed_stats (only resolve's stats instances take a
// histogram), else none
size_t bins_smem(const StepArgs* a) {
  const int nb = a->max_bounces + 1;
  return a->hist != nullptr && nb <= kSmemBins
             ? static_cast<size_t>(nb) * sizeof(int)
             : 0;
}

template <typename Kernel>
int launch(Kernel kernel, int block, const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  kernel<<<grid_of(a->n, block), block, bins_smem(a),
           static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// a resident grid of ``Kernel`` (the one-sample shade): SMs x its
// resident blocks an SM at ``block`` threads (the occupancy calculator),
// found once a device, and at most one block a tile of ``block`` lanes
template <void (*Kernel)(StepArgs)>
int launch_resident(int block, const StepArgs* a, void* stream) {
  static int slots[64] = {};
  if (a->n <= 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (slots[dev] == 0) {
    int sms = 0, blocks = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel,
                                                        block, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    slots[dev] = sms * blocks;
  }
  const int grid = std::min(grid_of(a->n, block), slots[dev]);
  Kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int info(Kernel kernel, int block, int* regs, int* local, int* blk,
         int* blocks) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = at.numRegs;
  *local = static_cast<int>(at.localSizeBytes);
  *blk = block;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, block, 0));
}

}  // namespace

// The entry points take the argument block (kernels/step.py StepArgs) and
// torch's current stream; each returns the launch's CUDA error code (0
// when queued).  route needs counts zeroed; shade the counts route left;
// resolve the counts shade left.
extern "C" int rtjax_step_route(const StepArgs* a, void* stream) {
  return launch(route_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_shade(const StepArgs* a, void* stream) {
  return launch(shade_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_resolve(const StepArgs* a, void* stream) {
  return launch(resolve_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_route_v1(const StepArgs* a, void* stream) {
  return launch(route_v1_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_shade_v1(const StepArgs* a, void* stream) {
  return launch(shade_v1_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_route_shade_unsorted(const StepArgs* a,
                                               void* stream) {
  return launch(route_shade_unsorted_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_route_parity(const StepArgs* a, void* stream) {
  return launch(route_parity_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_shade_parity(const StepArgs* a, void* stream) {
  return launch(shade_parity_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_resolve_parity(const StepArgs* a, void* stream) {
  return launch(resolve_parity_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_route_parity_unsorted(const StepArgs* a,
                                                void* stream) {
  return launch(route_parity_unsorted_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_shade_parity_unsorted(const StepArgs* a,
                                                void* stream) {
  return launch(shade_parity_unsorted_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_shade_1s(const StepArgs* a, void* stream) {
  return launch_resident<shade_1s_kernel>(kShadeBlock, a, stream);
}

extern "C" int rtjax_step_shade_1s_v1(const StepArgs* a, void* stream) {
  return launch(shade_1s_v1_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_route_shade_unsorted_1s(const StepArgs* a,
                                                  void* stream) {
  return launch(route_shade_unsorted_1s_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_route_wide(const StepArgs* a, void* stream) {
  return launch(route_wide_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_shade_wide(const StepArgs* a, void* stream) {
  return launch(shade_wide_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_shade_wide_1s(const StepArgs* a, void* stream) {
  return launch(shade_wide_1s_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_resolve_1s(const StepArgs* a, void* stream) {
  return launch(resolve_1s_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_resolve_stats(const StepArgs* a, void* stream) {
  return launch(resolve_stats_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_resolve_1s_stats(const StepArgs* a, void* stream) {
  return launch(resolve_1s_stats_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_route_shade_unsorted_v1(const StepArgs* a,
                                                  void* stream) {
  return launch(route_shade_unsorted_v1_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_route_shade_unsorted_1s_v1(const StepArgs* a,
                                                     void* stream) {
  return launch(route_shade_unsorted_1s_v1_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_resolve_parity_stats(const StepArgs* a,
                                               void* stream) {
  return launch(resolve_parity_stats_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_resolve_parity_stats_v1(const StepArgs* a,
                                                  void* stream) {
  return launch(resolve_parity_stats_v1_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_route_parity_v1(const StepArgs* a, void* stream) {
  return launch(route_parity_v1_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_shade_parity_v1(const StepArgs* a, void* stream) {
  return launch(shade_parity_v1_kernel, kShadeBlock, a, stream);
}

extern "C" int rtjax_step_route_parity_unsorted_v1(const StepArgs* a,
                                                   void* stream) {
  return launch(route_parity_unsorted_v1_kernel, kBlock, a, stream);
}

extern "C" int rtjax_step_shade_parity_unsorted_v1(const StepArgs* a,
                                                   void* stream) {
  return launch(shade_parity_unsorted_v1_kernel, kShadeBlock, a, stream);
}

// A kernel's registers, local bytes a thread, threads a block and
// resident blocks an SM (kernels/step.py KERNEL_IDS: 0 route, 1 shade, 2
// resolve, 3 route_v1, 4 shade_v1, 5 route_shade_unsorted, 6
// route_parity, 7 shade_parity, 8 resolve_parity, 9
// route_parity_unsorted, 10 shade_parity_unsorted, 11 shade_1s, 12
// route_shade_unsorted_1s, 13 route_wide, 14 shade_wide, 15
// shade_wide_1s, 16 resolve_1s, 17 resolve_stats, 18 resolve_1s_stats,
// 19 resolve_parity_stats, 20 route_parity_v1, 21 shade_parity_v1, 22
// route_parity_unsorted_v1, 23 shade_parity_unsorted_v1, 24
// route_shade_unsorted_v1, 25 route_shade_unsorted_1s_v1, 26 shade_1s_v1,
// 27 resolve_parity_stats_v1).
extern "C" int rtjax_step_kernel_info(int which, int* regs, int* local,
                                      int* block, int* blocks) {
  switch (which) {
    case 0: return info(route_kernel, kBlock, regs, local, block, blocks);
    case 1: return info(shade_kernel, kShadeBlock, regs, local, block,
                        blocks);
    case 2: return info(resolve_kernel, kBlock, regs, local, block, blocks);
    case 3: return info(route_v1_kernel, kBlock, regs, local, block,
                        blocks);
    case 4: return info(shade_v1_kernel, kBlock, regs, local, block, blocks);
    case 5: return info(route_shade_unsorted_kernel, kShadeBlock, regs,
                        local, block, blocks);
    case 6: return info(route_parity_kernel, kBlock, regs, local, block,
                        blocks);
    case 7: return info(shade_parity_kernel, kShadeBlock, regs, local, block,
                        blocks);
    case 8: return info(resolve_parity_kernel, kBlock, regs, local, block,
                        blocks);
    case 9: return info(route_parity_unsorted_kernel, kBlock, regs, local,
                        block, blocks);
    case 10: return info(shade_parity_unsorted_kernel, kShadeBlock, regs,
                         local, block, blocks);
    case 11: return info(shade_1s_kernel, kShadeBlock, regs, local, block,
                         blocks);
    case 12: return info(route_shade_unsorted_1s_kernel, kShadeBlock, regs,
                         local, block, blocks);
    case 13: return info(route_wide_kernel, kBlock, regs, local, block,
                         blocks);
    case 14: return info(shade_wide_kernel, kShadeBlock, regs, local, block,
                         blocks);
    case 15: return info(shade_wide_1s_kernel, kShadeBlock, regs, local,
                         block, blocks);
    case 16: return info(resolve_1s_kernel, kBlock, regs, local, block,
                         blocks);
    case 17: return info(resolve_stats_kernel, kBlock, regs, local, block,
                         blocks);
    case 18: return info(resolve_1s_stats_kernel, kBlock, regs, local, block,
                         blocks);
    case 19: return info(resolve_parity_stats_kernel, kBlock, regs, local,
                         block, blocks);
    case 20: return info(route_parity_v1_kernel, kBlock, regs, local, block,
                         blocks);
    case 21: return info(shade_parity_v1_kernel, kShadeBlock, regs, local,
                         block, blocks);
    case 22: return info(route_parity_unsorted_v1_kernel, kBlock, regs,
                         local, block, blocks);
    case 23: return info(shade_parity_unsorted_v1_kernel, kShadeBlock, regs,
                         local, block, blocks);
    case 24: return info(route_shade_unsorted_v1_kernel, kShadeBlock, regs,
                         local, block, blocks);
    case 25: return info(route_shade_unsorted_1s_v1_kernel, kShadeBlock,
                         regs, local, block, blocks);
    case 26: return info(shade_1s_v1_kernel, kShadeBlock, regs, local, block,
                         blocks);
    case 27: return info(resolve_parity_stats_v1_kernel, kBlock, regs, local,
                         block, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
