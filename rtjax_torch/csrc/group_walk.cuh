// One group walk over the wide-node tables of rtjax_torch/accel/wide.py,
// shared by the packet kernels (a CTA-wide group) and the lane kernels (a
// one-warp group) of packet_traverse.cu.
//
// A group is G consecutive rays, one per thread; the rays past the end of
// the batch and the inactive ones take part with an empty mask.  One
// cursor walks the tree for the whole group (the plain PyTorch version in
// kernels/wide.py walks the same order):
//
// - at a node, each live ray slab-tests every non-empty child against its
//   own tmax (slab_hits) and Moeller-Trumbore-tests the leaf children its
//   own slab accepted, in ascending slot order (leaf_closest / leaf_any,
//   the persist kernels' per-ray rule: packet hits equal persist hits,
//   ties at equal t aside);
// - the internal children accepted by any live ray form the group's mask
//   (an OR over the group); the cursor descends into its first child in
//   the node's build-time axis order, reversed when the group's octant
//   points down that axis, and pushes the rest as one (node,
//   remaining-mask) entry; it pops when the mask is empty;
// - the group's octant: bit k set when more than half of the group's
//   active rays point down axis k (an integer vote, so kernel and plain
//   version decide alike);
// - any hit: an occluded ray stops; the group stops when no ray is live.
//
// Barriers: every thread of the group runs every step, live or not, and
// reaches each collective.  G == 32 uses warp collectives only; G > 32
// uses shared memory with two __syncthreads per step: one before the
// leader (thread 0) reads the per-warp masks, one after it writes the next
// cursor.  Only the leader touches the group's stack (shared memory,
// ``stack_len`` entries sized from the tree depth by the caller).

#pragma once

#include <cuda_runtime.h>

#include "wide_walk.cuh"

namespace rtjax {

constexpr unsigned kLiveBit = 1u << 31;  // above every child bit (W <= 16)
constexpr unsigned kFull = 0xffffffffu;

// Per-block scratch of the G > 32 collectives.
struct GroupScratch {
  unsigned mask[32];  // one OR per warp
  int sum[32];        // one sum per warp
  int cur;            // the leader's next cursor
};

// Group-wide sum, returned to every thread of the group.
template <int G>
__device__ __forceinline__ int group_sum(int v, GroupScratch* s) {
  int w = __reduce_add_sync(kFull, v);
  if constexpr (G == 32) {
    return w;
  } else {
    if ((threadIdx.x & 31) == 0) s->sum[threadIdx.x >> 5] = w;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int k = 0; k < G / 32; ++k) total += s->sum[k];
    __syncthreads();
    return total;
  }
}

// Group-wide OR; valid in the group's leader only.
template <int G>
__device__ __forceinline__ unsigned group_or(unsigned v, GroupScratch* s) {
  unsigned w = __reduce_or_sync(kFull, v);
  if constexpr (G == 32) {
    return w;
  } else {
    if ((threadIdx.x & 31) == 0) s->mask[threadIdx.x >> 5] = w;
    __syncthreads();
    unsigned u = 0u;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < G / 32; ++k) u |= s->mask[k];
    }
    return u;
  }
}

// The leader's value, returned to every thread of the group.
template <int G>
__device__ __forceinline__ int group_bcast(int v, GroupScratch* s) {
  if constexpr (G == 32) {
    return __shfl_sync(kFull, v, 0);
  } else {
    if (threadIdx.x == 0) s->cur = v;
    __syncthreads();
    return s->cur;
  }
}

// The group's octant by majority vote over its active rays; -1 when the
// group has no active ray (then it walks nothing).
template <int G>
__device__ __forceinline__ int group_octant(bool act, const Ray& r,
                                            GroupScratch* s) {
  int n = group_sum<G>(act ? 1 : 0, s);
  if (n == 0) return -1;
  int oct = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int neg = group_sum<G>(act && ((r.oct >> k) & 1u) ? 1 : 0, s);
    if (2 * neg > n) oct |= 1 << k;
  }
  return oct;
}

// The walk of one group from the root.  Closest hit (ANY false): each
// active ray's best hit lands in ``best``.  Any hit: ``*occ`` is set for
// each ray that an accepted hit other than its ``exclude`` prim occludes.
// ``stack_node`` / ``stack_mask`` are the group's stack (leader only).
template <int W, int G, bool ANY>
__device__ __forceinline__ void group_walk(
    const float* __restrict__ nb, const int* __restrict__ cm,
    const int* __restrict__ ni, const float* __restrict__ lt, const Ray& r,
    bool act, float tmax, int exclude, Closest* best, bool* occ,
    int* stack_node, unsigned* stack_mask, GroupScratch* s) {
  constexpr unsigned kAll = (1u << W) - 1u;
  const bool leader = (threadIdx.x % G) == 0;
  const int oct = group_octant<G>(act, r, s);
  if (oct < 0) return;  // uniform over the group
  int sp = 0;           // the leader's stack depth
  int cur = 0;
  while (true) {
    const float* row = nb + (size_t)cur * 128;
    const int* meta = cm + (size_t)cur * W;
    const int info = __ldg(ni + cur);
    const unsigned lm = (unsigned)info & kAll;
    unsigned inner = 0u;
    if (act && !*occ) {
      unsigned hits = slab_hits<W>(row, meta, lm, r, tmax);
      unsigned leaves = hits & lm;
      while (leaves) {
        int c = __ffs(leaves) - 1;
        leaves &= leaves - 1u;
        int mc = __ldg(meta + c);
        const float* lrow = lt + (size_t)(mc >> 4) * 128;
        if constexpr (ANY) {
          if (leaf_any(lrow, mc & 15, r, tmax, exclude)) {
            *occ = true;
            break;
          }
        } else {
          leaf_closest(lrow, mc & 15, r, &tmax, best);
        }
      }
      if (!*occ) inner = (hits & ~lm & kAll) | kLiveBit;
    }
    const unsigned u = group_or<G>(inner, s);
    int next = -1;
    if (leader) {
      const unsigned m = u & kAll;
      if (ANY && !(u & kLiveBit)) {
        next = -1;  // every ray of the group is occluded
      } else if (m) {
        unsigned rev = (unsigned)(oct >> ((info >> W) & 3)) & 1u;
        int first = pick(m, rev);
        unsigned rest = m & ~(1u << first);
        if (rest) {
          stack_node[sp] = cur;
          stack_mask[sp] = (rest << 1) | rev;
          ++sp;
        }
        next = __ldg(meta + first) >> 4;
      } else if (sp > 0) {
        int pnode = stack_node[sp - 1];
        unsigned pm = stack_mask[sp - 1];
        unsigned pmask = pm >> 1, rev = pm & 1u;
        int first = pick(pmask, rev);
        unsigned rest = pmask & ~(1u << first);
        if (rest == 0u) --sp; else stack_mask[sp - 1] = (rest << 1) | rev;
        next = __ldg(cm + (size_t)pnode * W + first) >> 4;
      }
    }
    cur = group_bcast<G>(next, s);
    if (cur < 0) return;
  }
}

}  // namespace rtjax
