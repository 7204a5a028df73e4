// The packet walk of packet_traverse.cu's packet kernels: one cursor down
// the wide-node tables of rtjax_torch/accel/wide.py for a packet of
// kPacket consecutive rays, one ray per thread, kPackets packets per block.
// The plain PyTorch version (kernels/wide.py, ``decide_first=True``) walks
// the same order.
//
// One step at node ``cur``, whose box rows and metas sit in shared memory:
//
// - each live ray slab-tests every non-empty child against its own tmax,
//   reading the staged row (every thread reads the same words: a shared
//   memory broadcast);
// - each warp ORs its rays' internal-child and leaf-child masks into the
//   slots of this step's parity, and the packet meets at one barrier
//   (``bar.sync``, one id per packet); every thread then ORs the slots and
//   takes the same decision, so nothing is broadcast after it;
// - the decision: the internal children accepted by any live ray form the
//   mask; the cursor descends into its first child in the node's build-time
//   axis order, reversed when the packet's octant points down that axis,
//   and the rest are pushed as child ids in reverse pick order, so that a
//   pop is one shared-memory read; with an empty mask the cursor pops; any
//   hit: a packet with no live ray stops;
// - the leader thread starts the copy of the next node's boxes and metas
//   into the other buffer and of the leaf rows accepted by any live ray
//   into the leaf buffer (cp.async.bulk, completed on an mbarrier);
// - each live ray tests the leaf children its own slab accepted, in
//   ascending slot order, from the staged rows (persist.py's per-ray rule:
//   packet hits are the persistent walkers' hits, ties at equal t aside),
//   while the next node's copy is in flight.
//
// The decision comes before the leaf tests.  Closest hit: a node's internal
// mask depends only on its slab tests, so the order is the one a decision
// after the leaf tests would take.  Any hit: a ray occluded at this node's
// leaves still adds its internal children, and a packet whose last live ray
// is occluded stops at the next step; occlusion does not depend on the
// order, so only the work differs.
//
// Shared memory: PacketShared per packet (static) and a child-id stack of
// ``stack_len`` ints per packet (dynamic; (depth + 1) * (W - 1) entries,
// sized by the caller).
//
// A stats instance (packet_walk<W, ANY, true>) also counts, per ray, the
// plain group walk's ``node_visits`` and ``leaf_rows`` (kernels/wide.py,
// persist.new_work): a node visit for each step at which the ray is live
// (active and, for any hit, not occluded), a leaf row for each row the ray
// tests.  The default instances (STATS false) compile as before.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fetch_walk.cuh"
#include "wide_walk.cuh"

namespace rtjax {

constexpr int kPacket = 32;   // rays per packet: one warp
constexpr int kPackets = 4;   // packets per block
constexpr int kPacketWarps = kPacket / 32;
constexpr unsigned kLiveRay = 1u << 31;  // above every child bit (W <= 16)
constexpr unsigned kAllLanes = 0xffffffffu;
// bytes copied per staged leaf row: 8 slots of 12 floats and the 8 prim ids
constexpr unsigned kLeafBytes = 4 * (kPidBase + 8);
static_assert(kPacket % 32 == 0 && kPackets * kPacket <= 1024,
              "a packet is whole warps and a block at most 1024 threads");
static_assert(kPackets <= 15, "one named barrier per packet");

template <int W>
struct alignas(16) PacketShared {
  float row[2][6 * W];             // the node's child boxes, double-buffered
  int meta[2][W];                  // its child metas
  float leaf[W][kPidBase + 8];     // the node's staged leaf rows, by slot
  unsigned long long node_bar[2];  // completion of each node buffer's copy
  unsigned long long leaf_bar;     // completion of the leaf rows' copy
  unsigned inner[2][kPacketWarps];   // per warp, by step parity
  unsigned leaves[2][kPacketWarps];
  int vote[4][kPacketWarps];       // the octant vote: active, and per axis
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The packet's barrier: id 1 + its index in the block, kPacket threads.
__device__ __forceinline__ void packet_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kPacket) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// The leader's arrival, announcing ``bytes`` of copies on ``bar``.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completed on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order the packet's earlier reads of a buffer before the copy that
// overwrites it (the copy runs in the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Leader: copy node ``node``'s boxes and metas into buffer ``buf``.
template <int W>
__device__ __forceinline__ void stage_node(PacketShared<W>& sh, int buf,
                                           const float* __restrict__ nb,
                                           const int* __restrict__ cm,
                                           int node) {
  fence_async_shared();
  mbar_expect(&sh.node_bar[buf], 28 * W);
  bulk_copy(sh.row[buf], nb + (size_t)node * 128, 24 * W, &sh.node_bar[buf]);
  bulk_copy(sh.meta[buf], cm + (size_t)node * W, 4 * W, &sh.node_bar[buf]);
}

// Leader: copy the leaf rows of the slots in ``slots`` (metas ``meta``).
template <int W>
__device__ __forceinline__ void stage_leaves(PacketShared<W>& sh,
                                             unsigned slots, const int* meta,
                                             const float* __restrict__ lt) {
  fence_async_shared();
  mbar_expect(&sh.leaf_bar, kLeafBytes * __popc(slots));
  while (slots) {
    const int c = __ffs(slots) - 1;
    slots &= slots - 1u;
    bulk_copy(sh.leaf[c], lt + (size_t)(meta[c] >> 4) * 128, kLeafBytes,
              &sh.leaf_bar);
  }
}

// slab_hits_v over a staged row and metas (shared memory, plain loads).
template <int W>
__device__ __forceinline__ unsigned slab_hits_s(const float* row,
                                                const int* meta,
                                                unsigned leaf_mask,
                                                const Ray& r, float tmax) {
  const int4* m = reinterpret_cast<const int4*>(meta);
  unsigned empty = 0u;
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const int4 v = m[k];
    empty |= ((v.x & 15) == 0 ? 1u : 0u) << (4 * k);
    empty |= ((v.y & 15) == 0 ? 1u : 0u) << (4 * k + 1);
    empty |= ((v.z & 15) == 0 ? 1u : 0u) << (4 * k + 2);
    empty |= ((v.w & 15) == 0 ? 1u : 0u) << (4 * k + 3);
  }
  const float4* q = reinterpret_cast<const float4*>(row);
  unsigned hits = 0u;
#pragma unroll
  for (int p = 0; p < W / 2; ++p) {
    const float4 a = q[3 * p];
    const float4 b = q[3 * p + 1];
    const float4 c = q[3 * p + 2];
    if (slab_accept(a.x, a.y, a.z, a.w, b.x, b.y, r, tmax))
      hits |= 1u << (2 * p);
    if (slab_accept(b.z, b.w, c.x, c.y, c.z, c.w, r, tmax))
      hits |= 2u << (2 * p);
  }
  return hits & ~(empty & leaf_mask);
}

// leaf_closest_v / leaf_any_v over a staged leaf row.
__device__ __forceinline__ bool leaf_closest_s(const float* row, int count,
                                               const Ray& r, float* tmax,
                                               Closest* best) {
  const float4* q = reinterpret_cast<const float4*>(row);
  float rb_t = kBig, rnx = 0.0f, rny = 0.0f, rnz = 0.0f;
  int rb_s = -1;
  for (int s = 0; s < count; ++s) {
    const float4 v[3] = {q[3 * s], q[3 * s + 1], q[3 * s + 2]};
    float t;
    if (mt_slot4(v, r, *tmax, &t) && t < rb_t) {
      rb_t = t; rb_s = s;
      rnx = v[2].y; rny = v[2].z; rnz = v[2].w;
    }
  }
  if (rb_s < 0) return false;
  *tmax = rb_t;
  best->t = rb_t;
  best->prim = __float2int_rn(row[kPidBase + rb_s]);
  best->nx = rnx; best->ny = rny; best->nz = rnz;
  return true;
}

__device__ __forceinline__ bool leaf_any_s(const float* row, int count,
                                           const Ray& r, float tmax,
                                           int exclude) {
  const float4* q = reinterpret_cast<const float4*>(row);
  for (int s = 0; s < count; ++s) {
    const float4 v[3] = {q[3 * s], q[3 * s + 1], q[3 * s + 2]};
    float t;
    if (mt_slot4(v, r, tmax, &t) &&
        __float2int_rn(row[kPidBase + s]) != exclude)
      return true;
  }
  return false;
}

// The walk of one packet from the root.  Closest hit (ANY false): each
// active ray's best hit lands in ``best``.  Any hit: ``*occ`` is set for
// each ray that an accepted hit other than its ``exclude`` prim occludes.
// ``pk`` is the packet's index in its block; every thread of the packet
// must call it.  With STATS, ``*cnt`` counts the ray's node visits and leaf
// rows.
template <int W, bool ANY, bool STATS = false>
__device__ __forceinline__ void packet_walk(
    const float* __restrict__ nb, const int* __restrict__ cm,
    const int* __restrict__ ni, const float* __restrict__ lt, const Ray& r,
    bool act, float tmax, int exclude, Closest* best, bool* occ, int* stack,
    PacketShared<W>& sh, int pk, Counts* cnt = nullptr) {
  constexpr unsigned kAll = (1u << W) - 1u;
  const int t = threadIdx.x - pk * kPacket;
  const int warp = t >> 5, lane = t & 31;
  const bool leader = t == 0;
  const int bar = 1 + pk;
  if (leader) {
    mbar_init(&sh.node_bar[0]);
    mbar_init(&sh.node_bar[1]);
    mbar_init(&sh.leaf_bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the octant: bit k set when more than half of the active rays point
  // down axis k (an integer vote, as the plain version takes it)
  const int votes[4] = {act ? 1 : 0, act && (r.oct & 1u) ? 1 : 0,
                        act && (r.oct & 2u) ? 1 : 0,
                        act && (r.oct & 4u) ? 1 : 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int w = __reduce_add_sync(kAllLanes, votes[k]);
    if (lane == 0) sh.vote[k][warp] = w;
  }
  packet_sync(bar);
  int count[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    for (int j = 0; j < kPacketWarps; ++j) count[k] += sh.vote[k][j];
  if (count[0] == 0) return;  // no active ray: the packet walks nothing
  int oct = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (2 * count[k + 1] > count[0]) oct |= 1 << k;

  unsigned phase = 0u;  // parity of each barrier's next phase: node 0, 1, leaf
  int cur = 0;  // the node visited (its rows are in buffer ``buf``)
  int buf = 0, sp = 0, par = 0;
  int info = __ldg(ni);
  if (leader) stage_node<W>(sh, 0, nb, cm, 0);
  while (true) {
    mbar_wait(&sh.node_bar[buf], (phase >> buf) & 1u);
    phase ^= 1u << buf;
    const unsigned lm = (unsigned)info & kAll;
    const bool live = act && !*occ;
    if constexpr (STATS) cnt->nodes += live ? 1u : 0u;
    const unsigned hits =
        live ? slab_hits_s<W>(sh.row[buf], sh.meta[buf], lm, r, tmax) : 0u;
    const unsigned mine = hits & lm;  // this ray's leaf children
    const unsigned inner = (hits & ~lm & kAll) | (live ? kLiveRay : 0u);
    const unsigned wi = __reduce_or_sync(kAllLanes, inner);
    const unsigned wl = __reduce_or_sync(kAllLanes, mine);
    if (lane == 0) {
      sh.inner[par][warp] = wi;
      sh.leaves[par][warp] = wl;
    }
    packet_sync(bar);
    unsigned u = 0u, slots = 0u;
#pragma unroll
    for (int j = 0; j < kPacketWarps; ++j) {
      u |= sh.inner[par][j];
      slots |= sh.leaves[par][j];
    }
    par ^= 1;
    const unsigned m = u & kAll;
    int next = -1;
    if (ANY && !(u & kLiveRay)) {
      next = -1;  // every ray of the packet is occluded
    } else if (m) {
      const unsigned rev = (unsigned)(oct >> ((info >> W) & 3)) & 1u;
      const int first = pick(m, rev);
      unsigned rest = m & ~(1u << first);
      // the rest as child ids, the last to be picked first, so that the
      // top is the next in pick order; the leader writes
      for (int k = sp; leader && rest; ++k) {
        const int c = rev ? __ffs(rest) - 1 : 31 - __clz(rest);
        rest &= ~(1u << c);
        stack[k] = sh.meta[buf][c] >> 4;
      }
      sp += __popc(m) - 1;
      next = sh.meta[buf][first] >> 4;
    } else if (sp > 0) {
      next = stack[--sp];  // every thread reads the same word
    }
    int next_info = 0;
    if (next >= 0) {
      next_info = __ldg(ni + next);
      if (leader) stage_node<W>(sh, buf ^ 1, nb, cm, next);
    }
    if (slots) {
      if (leader) stage_leaves<W>(sh, slots, sh.meta[buf], lt);
      mbar_wait(&sh.leaf_bar, (phase >> 2) & 1u);
      phase ^= 4u;
      while (slots) {
        const int c = __ffs(slots) - 1;
        slots &= slots - 1u;
        if (!((mine >> c) & 1u)) continue;
        const int count_c = sh.meta[buf][c] & 15;
        if constexpr (ANY) {
          if constexpr (STATS) cnt->leaves += *occ ? 0u : 1u;
          if (!*occ && leaf_any_s(sh.leaf[c], count_c, r, tmax, exclude))
            *occ = true;
        } else {
          if constexpr (STATS) ++cnt->leaves;
          leaf_closest_s(sh.leaf[c], count_c, r, &tmax, best);
        }
      }
    }
    if (next < 0) return;
    cur = next;
    buf ^= 1;
    info = next_info;
  }
}

}  // namespace rtjax
