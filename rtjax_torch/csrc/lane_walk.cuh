// The lane walk of packet_traverse.cu's lane kernels: one cursor down the
// wide-node tables of rtjax_torch/accel/wide.py for a lane group of 32
// consecutive rays, one warp, one ray per thread.  The warps of a block
// walk on their own and draw their groups from a work counter.  The plain
// PyTorch version (kernels/wide.py at ``group`` = 32, ``decide_first``
// True) walks the same order.
//
// rtjax's lane kernels run 16 sublane walkers of 128 rays per tile; their
// exchange buffer, leaf queues and tile barrier hide the TPU's
// vector-to-scalar latency and have no counterpart here.  A warp's votes
// are warp collectives, and a warp never waits for another.
//
// One step at the cursor's node, whose child boxes and metas sit in the
// warp's shared buffer:
// - each live ray slab-tests every non-empty child against its own tmax,
//   reading the staged row (shared-memory broadcasts);
// - __reduce_or_sync gives every lane the warp's leaf-slot mask and, at
//   the decision, its internal-child mask over the rays live then, so
//   every lane takes the same decision with no barrier and no shared slot;
// - the decision: the cursor descends into the mask's first child in the
//   node's build-time axis order, reversed when the warp's octant points
//   down that axis; the other children's ids are pushed, the last to be
//   picked at the bottom, each by the lane of its slot; an empty mask pops
//   one id;
// - each lane loads one 16-byte word of the next node's row (boxes, then
//   metas: 28 lanes at width 16, 14 at width 8) into a register, and
//   stores it into the other buffer at the end of the step;
// - the leaf rows that any live ray accepted are staged kLaneRows at a
//   time (lane l loads word l of each row where the row holds a real
//   triangle or its prim ids), and each live ray tests the rows its own
//   slab accepted, in ascending slot order (persist.py's per-ray rule).
//
// Both kernels decide before the leaf tests, so the next node's loads are
// in flight while they run.  For closest hit a node's mask depends only on
// its slab tests, so the order is the one of deciding after them.  For any
// hit it is the packet kernels' rule (``decide_first`` True): a ray
// occluded at a node's leaves still adds that node's internal children,
// and the warp stops at the first step that finds none of its rays live.
// rtjax's lane rule (decide after the leaf tests, so that an occluded ray
// adds nothing) visits ~1% fewer nodes but loses the overlap, and was
// slower on the H100 (PERF.md; tools/persist_variants.py --kernels lane,
// "decide after (any hit)").  Occlusion is the same under both.
//
// Shared memory per warp: LaneShared<W> and a child-id stack of
// ``stack_len`` ints, (depth + 1) * (W - 1) (kernels/lane.py), rounded up
// to 16 bytes; lane_warp_bytes() is the sum.

#pragma once

#include <cuda_runtime.h>

#include "fetch_walk.cuh"
#include "packet_walk.cuh"

namespace rtjax {

constexpr int kLane = 32;          // rays per lane group (one warp)
constexpr int kLaneWarps = 8;      // warps a block, where their stacks fit
constexpr int kLaneRows = 4;       // leaf rows staged at a time
constexpr int kLaneThreads = 512;  // launch bound: at most 16 warps a block
static_assert(kLaneWarps * kLane <= kLaneThreads, "a block's warps");

template <int W>
struct alignas(16) LaneShared {
  float node[2][7 * W];                 // boxes (6W floats), then metas (W
                                        // ints), double-buffered
  float leaf[kLaneRows][kPidBase + 8];  // the staged leaf rows
};

// Shared-memory bytes of one warp: LaneShared<W> and ``stack_len`` child
// ids, 16-byte aligned.
template <int W>
__host__ __device__ constexpr int lane_warp_bytes(int stack_len) {
  return static_cast<int>(sizeof(LaneShared<W>)) +
         (4 * stack_len + 15) / 16 * 16;
}

// The staging of a node's row into one of the warp's buffers: start()
// starts it, land() completes it for the whole warp.  Each lane loads one
// 16-byte word (child boxes below lane 3W/2, then metas) into a register
// and stores it at land().  start() takes the buffer it does not use so
// that tools/persist_variants.py's bulk-copy variant fits the same calls.
template <int W>
struct NodeStage {
  float4 word;

  __device__ __forceinline__ void start(LaneShared<W>& sh, int buf,
                                        const float* __restrict__ nb,
                                        const int* __restrict__ cm,
                                        int node, int lane) {
    if (lane < 3 * W / 2) {
      word = __ldg(reinterpret_cast<const float4*>(nb + (size_t)node * 128) +
                   lane);
    } else if (lane < 7 * W / 4) {
      const int4 m = __ldg(reinterpret_cast<const int4*>(
                               cm + (size_t)node * W) + lane - 3 * W / 2);
      word = make_float4(__int_as_float(m.x), __int_as_float(m.y),
                         __int_as_float(m.z), __int_as_float(m.w));
    }
  }

  __device__ __forceinline__ void land(LaneShared<W>& sh, int buf,
                                       int lane) {
    if (lane < 7 * W / 4)
      reinterpret_cast<float4*>(sh.node[buf])[lane] = word;
    __syncwarp();
  }
};

// Stage the leaf rows of the slots in ``chunk`` (at most kLaneRows, in
// ascending slot order) into sh.leaf: lane l < 26 loads word l of each row
// where it holds a real triangle (three words a slot) or the prim ids
// (words 24 and 25); then the lanes store them.
template <int W>
__device__ __forceinline__ void stage_rows(LaneShared<W>& sh, unsigned chunk,
                                           const int* meta,
                                           const float* __restrict__ lt,
                                           int lane) {
  float4 v[kLaneRows];
  bool used[kLaneRows];
#pragma unroll
  for (int k = 0; k < kLaneRows; ++k) {
    used[k] = false;
    if (chunk) {
      const int mc = meta[__ffs(chunk) - 1];
      chunk &= chunk - 1u;
      used[k] = lane < 3 * (mc & 15) || lane == 24 || lane == 25;
      if (used[k])
        v[k] = __ldg(reinterpret_cast<const float4*>(
                         lt + (size_t)(mc >> 4) * 128) + lane);
    }
  }
#pragma unroll
  for (int k = 0; k < kLaneRows; ++k)
    if (used[k]) reinterpret_cast<float4*>(sh.leaf[k])[lane] = v[k];
  __syncwarp();
}

// The walk of one lane group from the root.  Closest hit (ANY false): each
// active ray's best hit lands in ``best``.  Any hit: ``*occ`` is set for
// each ray that an accepted hit other than its ``exclude`` prim occludes.
// ``stage`` is the warp's, kept from one walk to the next.  Every lane of
// the warp must call it.
template <int W, bool ANY>
__device__ __forceinline__ void lane_walk(const Tables& tb, const Ray& ray,
                                          bool act, float tmax, int exclude,
                                          Closest* best, bool* occ,
                                          LaneShared<W>& sh, int* stack,
                                          NodeStage<W>& stage) {
  constexpr unsigned kAll = (1u << W) - 1u;
  const int lane = threadIdx.x & 31;
  // the octant: bit k set when more than half of the active rays point
  // down axis k (an integer vote, as the plain version takes it)
  const int count = __reduce_add_sync(kAllLanes, act ? 1 : 0);
  if (count == 0) return;  // no active ray: the warp walks nothing
  int oct = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (2 * __reduce_add_sync(kAllLanes,
                              act && ((ray.oct >> k) & 1u) ? 1 : 0) > count)
      oct |= 1 << k;

  // the warp's previous walk is done with its buffers and stack
  __syncwarp();
  stage.start(sh, 0, tb.nb, tb.cm, 0, lane);
  int info = __ldg(tb.ni);
  stage.land(sh, 0, lane);
  int buf = 0, sp = 0;
  while (true) {
    const int* meta = reinterpret_cast<const int*>(sh.node[buf] + 6 * W);
    const unsigned lm = (unsigned)info & kAll;
    const unsigned hits =
        act && !*occ ? slab_hits_s<W>(sh.node[buf], meta, lm, ray, tmax) : 0u;
    const unsigned mine = hits & lm;  // this ray's leaf children
    const unsigned slots = __reduce_or_sync(kAllLanes, mine);
    int next_info = 0;
    // The decision over the rays live now, and the next node's loads.
    auto advance = [&]() -> int {
      const bool live = act && !*occ;
      const unsigned u = __reduce_or_sync(
          kAllLanes, live ? (hits & ~lm & kAll) | kLiveRay : 0u);
      const unsigned m = u & kAll;
      if (ANY && !(u & kLiveRay)) return -1;  // every ray is occluded
      int next = -1;
      if (m) {
        const unsigned rev = (unsigned)(oct >> ((info >> W) & 3)) & 1u;
        const int first = pick(m, rev);
        const unsigned rest = m & ~(1u << first);
        if (lane < W && ((rest >> lane) & 1u)) {
          const unsigned after = rev ? (1u << lane) - 1u : ~0u << (lane + 1);
          stack[sp + __popc(rest & after)] = meta[lane] >> 4;
        }
        sp += __popc(rest);
        next = meta[first] >> 4;
      } else if (sp > 0) {
        next = stack[--sp];  // every lane reads the same word
      }
      if (next >= 0) {
        stage.start(sh, buf ^ 1, tb.nb, tb.cm, next, lane);
        next_info = __ldg(tb.ni + next);
      }
      return next;
    };
    int next = advance();
    for (unsigned left = slots; left;) {
      unsigned chunk = 0u;  // the next kLaneRows slots
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        chunk |= left & (0u - left);
        left &= left - 1u;
      }
      stage_rows<W>(sh, chunk, meta, tb.lt, lane);
      int k = 0;
      for (unsigned c_left = chunk; c_left; c_left &= c_left - 1u, ++k) {
        const int c = __ffs(c_left) - 1;
        if (!((mine >> c) & 1u)) continue;
        if constexpr (ANY) {
          if (!*occ && leaf_any_s(sh.leaf[k], meta[c] & 15, ray, tmax,
                                  exclude))
            *occ = true;
        } else {
          leaf_closest_s(sh.leaf[k], meta[c] & 15, ray, &tmax, best);
        }
      }
      __syncwarp();  // every lane's tests before the rows are overwritten
    }
    if (next < 0) return;
    buf ^= 1;
    stage.land(sh, buf, lane);
    info = next_info;
  }
}

struct LaneOuts {
  unsigned char* hit;  // any hit: occluded
  float* t;
  int* prim;
  float *nx, *ny, *nz;
};

// One walk per lane group: each warp draws group indices from the work
// counter ``work`` (one atomicAdd a group) until they pass the batch; the
// last block to finish zeroes the counter for the next launch.  Lanes past
// the end and inactive rays take part with an empty mask.
template <int W, bool ANY>
__global__ void __launch_bounds__(kLaneThreads)
lane_kernel(const Tables tb, const Rays rays, const int n, const LaneOuts out,
            unsigned* __restrict__ work, const int stack_len) {
  extern __shared__ float4 lane_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* base = reinterpret_cast<char*>(lane_smem) +
               warp * lane_warp_bytes<W>(stack_len);
  LaneShared<W>& sh = *reinterpret_cast<LaneShared<W>*>(base);
  int* stack = reinterpret_cast<int*>(base + sizeof(LaneShared<W>));
  const unsigned groups = (unsigned)(n - 1) / kLane + 1u;
  NodeStage<W> stage;
  while (true) {
    unsigned g = 0u;
    if (lane == 0) g = atomicAdd(work, 1u);  // the warp's next group
    g = __shfl_sync(kAllLanes, g, 0);
    if (g >= groups) break;
    const int i = (int)g * kLane + lane;
    const bool act = i < n && rays.active[i];
    const Ray r = act ? load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy,
                                 rays.dz, i)
                      : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
    const float tmax = act ? rays.tmax[i] : 0.0f;
    bool occ = false;
    if constexpr (ANY) {
      lane_walk<W, true>(tb, r, act, tmax, act ? rays.exclude[i] : -1,
                         nullptr, &occ, sh, stack, stage);
      if (i < n) out.hit[i] = occ ? 1 : 0;
    } else {
      Closest best;
      lane_walk<W, false>(tb, r, act, tmax, -1, &best, &occ, sh, stack,
                          stage);
      if (i < n) {
        out.hit[i] = best.prim >= 0 ? 1 : 0;
        out.t[i] = best.t;
        out.prim[i] = best.prim;
        out.nx[i] = best.nx;
        out.ny[i] = best.ny;
        out.nz[i] = best.nz;
      }
    }
  }
  // the last block to finish resets the counter for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(work + 1, 1u) == gridDim.x - 1) {
      atomicExch(work, 0u);
      atomicExch(work + 1, 0u);
    }
  }
}

}  // namespace rtjax
