// The dynamic-fetch walk shared by the persistent walkers
// (persist_traverse.cu) and the two-level kernels (wide_inst_traverse.cu):
// a lane's walk state and its step over the wide tables, the warps' refill
// from a work counter, the counter's reset, and the resident grid.
//
// Dynamic fetch (Aila & Laine, "Understanding the Efficiency of Ray
// Traversal on GPUs", HPG 2009, persistent while-while): a grid of the
// card's resident blocks of kFetchBlock threads, each warp drawing rays
// from one work counter.  A lane whose ray is finished draws a new ray at
// the warp's next refill (one atomicAdd per warp for all its empty lanes;
// a kernel may wait until several lanes are empty), so a long walk holds
// one lane, not 31.  The counter is two words per device and stream that
// the kernel resets itself: the last block to finish zeroes them, so a
// launch costs no memset.
//
// The stack lives in shared memory, stack_len entries per thread laid out
// entry-major (a thread's entries kFetchBlock words apart), so that a
// warp's lanes touch 32 banks.  One step is the pending leaf rows of the
// current node, then the next node's visit: every lane of a warp visits a
// node in the same step.

#pragma once

#include <cuda_runtime.h>

#include "wide_walk.cuh"

namespace rtjax {

constexpr int kFetchBlock = 128;
constexpr unsigned kWarp = 0xffffffffu;
// leaf slots whose loads are issued together
constexpr int kLeafChunk = 4;
static_assert(8 % kLeafChunk == 0, "a leaf chunk must divide the 8 slots");

struct Tables {
  const float* nb;
  const int* cm;
  const int* ni;
  const float* lt;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  const unsigned char* active;
  const int* exclude;  // any hit only
};

// One lane's walk: its ray and where it stands.
struct Lane {
  Ray r;
  float tmax;
  int exclude;
  Closest best;
  int root;         // the walk's first node
  int cur;          // the node last visited; -1 before the root
  unsigned leaves;  // its hit leaf children not tested yet
  unsigned inner;   // its hit internal children
  unsigned rev;     // descend order at cur
  int sp;           // stack depth
};

// Start the lane's walk at node ``root`` with an empty stack.
__device__ __forceinline__ void enter(Lane& s, int root) {
  s.root = root;
  s.cur = -1;
  s.leaves = 0u;
  s.inner = 0u;
  s.sp = 0;
}

// One step of a lane's walk: the leaf rows pending at its node in
// ascending slot order, then the next node (the first hit internal child,
// the rest pushed as one entry; else the top of the stack; the root when
// nothing was visited yet) and its slab tests.  Returns true when the walk
// is over: the stack is empty, or (any hit) a leaf occludes.  ``*hit`` is
// set when a leaf row of this step occludes (any hit) or records a closer
// hit in ``s.best`` (closest hit).
template <int W, bool ANY>
__device__ __forceinline__ bool step(const Tables& tb, Lane& s,
                                     int* st_node, unsigned* st_mask,
                                     bool* hit) {
  constexpr unsigned kAll = (1u << W) - 1u;
  while (s.leaves) {
    const int c = __ffs(s.leaves) - 1;
    s.leaves &= s.leaves - 1u;
    const int mc = __ldg(tb.cm + (size_t)s.cur * W + c);
    const float* row = tb.lt + (size_t)(mc >> 4) * 128;
    if constexpr (ANY) {
      if (leaf_any_v<kLeafChunk>(row, mc & 15, s.r, s.tmax, s.exclude)) {
        *hit = true;
        return true;
      }
    } else {
      if (leaf_closest_v<kLeafChunk>(row, mc & 15, s.r, &s.tmax, &s.best))
        *hit = true;
    }
  }
  int next;
  if (s.cur < 0) {
    next = s.root;
  } else if (s.inner) {
    const int first = pick(s.inner, s.rev);
    const unsigned rest = s.inner & ~(1u << first);
    if (rest) {
      st_node[s.sp * kFetchBlock] = s.cur;
      st_mask[s.sp * kFetchBlock] = (rest << 1) | s.rev;
      ++s.sp;
    }
    next = __ldg(tb.cm + (size_t)s.cur * W + first) >> 4;
  } else if (s.sp > 0) {
    const int top = (s.sp - 1) * kFetchBlock;
    const int pnode = st_node[top];
    const unsigned pm = st_mask[top];
    const unsigned m = pm >> 1, rev = pm & 1u;
    const int first = pick(m, rev);
    const unsigned rest = m & ~(1u << first);
    if (rest == 0u) --s.sp; else st_mask[top] = (rest << 1) | rev;
    next = __ldg(tb.cm + (size_t)pnode * W + first) >> 4;
  } else {
    return true;
  }
  const int info = __ldg(tb.ni + next);
  const unsigned lm = (unsigned)info & kAll;
  const float* row = tb.nb + (size_t)next * 128;
  const int* meta = tb.cm + (size_t)next * W;
  const unsigned hits = slab_hits_v<W>(row, meta, lm, s.r, s.tmax);
  s.cur = next;
  s.leaves = hits & lm;
  s.inner = hits & ~lm & kAll;
  s.rev = (s.r.oct >> ((info >> W) & 3)) & 1u;
  return false;
}

// The loop of a fetch kernel's thread over the rays ``0..n-1``, drawn from
// the counter ``work``, and the counter's reset at the end.  ``job`` holds
// what differs between kernels:
//   kRefill: the warp draws rays once this many of its lanes are empty
//     (1..32);
//   bool start(Lane& s, int i): take ray i; false when it needs no walk
//     (inactive, or nothing to visit), its results then written;
//   bool after(Lane& s, int i, bool done, bool hit): after each step of
//     ray i (``done`` and ``hit`` as step returns them); true when ray i is
//     finished, its results then written.
// Every thread of the block must call it (it ends in __syncthreads).
template <int W, bool ANY, class Job>
__device__ __forceinline__ void fetch_rays(const Tables& tb, Job& job, int n,
                                           unsigned* work, int* st_node,
                                           unsigned* st_mask) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  bool more = true;  // warp-uniform: the counter may still hold rays
  int ray = -1;      // this lane's ray; -1 when it has none
  Lane s;
  while (true) {
    // refill: the empty lanes draw consecutive rays with one atomicAdd; a
    // ray that needs no walk is written out at once and its lane draws
    // again
    while (more) {
      const unsigned want = __ballot_sync(kWarp, ray < 0);
      if (__popc(want) < Job::kRefill) break;
      const int leader = __ffs(want) - 1;
      const unsigned k = __popc(want);
      unsigned base = 0u;
      if ((int)lane == leader) base = atomicAdd(work, k);
      base = __shfl_sync(kWarp, base, leader);
      more = base + k < (unsigned)n;
      if (ray < 0) {
        const unsigned i = base + __popc(want & below);
        if (i < (unsigned)n && job.start(s, (int)i)) ray = (int)i;
      }
    }
    if (__ballot_sync(kWarp, ray >= 0) == 0u) break;
    if (ray >= 0) {
      bool hit = false;
      const bool done = step<W, ANY>(tb, s, st_node, st_mask, &hit);
      if (job.after(s, ray, done, hit)) ray = -1;
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

// Blocks of ``Kernel`` (``threads`` threads, ``smem`` bytes of dynamic
// shared memory) for ``n`` rays, one a thread: as many as the card keeps
// resident, capped by the rays; -1 on a device this cache does not hold.
// Cached per kernel (each instance of a template its own), device, byte
// count and block size.  The kernel's dynamic shared-memory cap is raised
// above the default 48 KB where ``smem`` needs it and never lowered, so a
// cached count is never used under a cap that a smaller launch set.
template <auto Kernel>
int fetch_grid(int n, int smem, int threads = kFetchBlock) {
  constexpr int kDevices = 16;
  constexpr int kSlots = 8;
  static int key[kDevices][kSlots], blocks[kDevices][kSlots];
  static int cap[kDevices], slot[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kDevices) return -1;
  const int k = smem * 64 + threads / 32;  // smem < 2^24, threads <= 1024
  int resident = 0;
  for (int j = 0; j < kSlots; ++j)
    if (blocks[dev][j] > 0 && key[dev][j] == k) resident = blocks[dev][j];
  if (resident == 0) {
    if (smem > 48 * 1024 && smem > cap[dev]) {
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
      cap[dev] = smem;
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads,
                                                  smem);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    const int j = slot[dev]++ % kSlots;
    key[dev][j] = k;
    blocks[dev][j] = resident;
  }
  const int needed = (n + threads - 1) / threads;
  return needed < resident ? needed : resident;
}

}  // namespace rtjax
