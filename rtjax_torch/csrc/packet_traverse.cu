// Packet and lane BVH traversal for Hopper (sm_90a): closest hit and any
// hit over the wide-node tables of rtjax_torch/accel/wide.py, with one
// shared cursor per group of rays.
//
// Replaces: rtjax/kernels/pallas_wide.py, wide_traverse_closest
// (_make_closest_kernel) and wide_traverse_anyhit (_make_anyhit_kernel),
// a 2048-ray tile per walk; rtjax/kernels/pallas_lane.py,
// lane_traverse_closest (_make_lane_closest_kernel) and
// lane_traverse_anyhit (_make_lane_anyhit_kernel), a 128-ray sublane per
// walk.  Both compute one function in two schedules.  A packet is kPacket
// rays (packet_walk.cuh; a CTA holds at most 1024 threads, so the TPU's
// 2048-ray tile does not carry over), a lane group one warp
// (lane_walk.cuh).
//
// What bounds it on this card: the latency of each step's dependent loads
// (the node, then its leaf rows, then the next node) and, for packets, the
// packet's barrier per step, plus the union of its rays' node sets: every
// ray of a group pays for every node any of them needs.  The tables of the
// headline scene stay resident in the 50 MB L2; the tensor cores have
// nothing to do.
//
// What the packet design does about it (packet_walk.cuh): the leader copies
// the node's boxes and metas, and the leaf rows any ray accepted, into
// shared memory with bulk copies (one request each instead of 6 W loads per
// thread), every thread slab-tests from the shared row, the packet decides
// its next node before the leaf tests and copies it while they run, meets
// at one barrier per step, and pops child ids from a shared-memory stack.
// rtjax's deferred leaf queue, interleaved cursors and work-stealing stack
// hide the TPU's vector->scalar latency and have no counterpart here.
//
// What the lane design does about it (lane_walk.cuh): a group is one warp,
// so every vote is a warp collective and no step waits at a barrier; each
// lane loads one 16-byte word of the node's row and of each leaf row any
// ray accepted into the warp's shared buffers; the next node is decided
// before the leaf tests and loaded while they run; warps draw their groups
// from the persist kernels' self-resetting work counter, so a warp that
// finishes early takes the next group.
//
// The leader design (group_walk.cuh at kLeaderPacket rays, the
// ``rtjax_packet_leader_*`` entries) is the packet kernels' first design,
// and the same walk at one warp (``rtjax_lane_group_*``) the lane kernels'
// first design; both are kept to time each pair of designs in one run.
// Every thread loads the node row from global memory, one leader thread
// decides and broadcasts the cursor (two barriers a step) and keeps
// (node, mask) stack entries.
//
// Exactness: the build uses --fmad=false, so each product and sum rounds
// like the separate torch ops of the plain version (kernels/wide.py), which
// walks the same order; results agree bit for bit.

#include <cuda_runtime.h>

#include "group_walk.cuh"
#include "lane_walk.cuh"
#include "packet_walk.cuh"

namespace {

using rtjax::Closest;
using rtjax::fetch_grid;
using rtjax::GroupScratch;
using rtjax::kLane;
using rtjax::kLaneWarps;
using rtjax::lane_kernel;
using rtjax::lane_warp_bytes;
using rtjax::LaneOuts;
using rtjax::Ray;
using rtjax::Rays;
using rtjax::Tables;
using rtjax::group_walk;
using rtjax::load_ray;
using rtjax::make_ray;
using rtjax::kPacket;
using rtjax::kPackets;
using rtjax::PacketShared;
using rtjax::packet_walk;

constexpr int kLeaderPacket = 256;  // rays per packet of the leader design

// Threads per block: one packet, or four lane groups.
template <int G>
constexpr int block_threads() {
  return G < 128 ? 128 : G;
}

// This thread's ray (a unit ray when inactive or past the end) and
// whether it is active; the group's stack in dynamic shared memory.
struct Slot {
  int i;
  bool act;
  Ray r;
  int* stack_node;
  unsigned* stack_mask;
};

template <int G>
__device__ __forceinline__ Slot slot(const float* __restrict__ ox,
                                     const float* __restrict__ oy,
                                     const float* __restrict__ oz,
                                     const float* __restrict__ dx,
                                     const float* __restrict__ dy,
                                     const float* __restrict__ dz,
                                     const unsigned char* __restrict__ active,
                                     int n, int stack_len, int* smem) {
  Slot s;
  s.i = blockIdx.x * blockDim.x + threadIdx.x;
  s.act = s.i < n && active[s.i];
  s.r = s.act ? load_ray(ox, oy, oz, dx, dy, dz, s.i)
              : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  int g = threadIdx.x / G;  // the group's index within the block
  s.stack_node = smem + 2 * stack_len * g;
  s.stack_mask = reinterpret_cast<unsigned*>(s.stack_node + stack_len);
  return s;
}

template <int W, int G>
__global__ void __launch_bounds__(G < 128 ? 128 : G)
group_closest_kernel(const float* __restrict__ nb, const int* __restrict__ cm,
                     const int* __restrict__ ni, const float* __restrict__ lt,
                     const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tmax_in,
                     const unsigned char* __restrict__ active, int n,
                     int stack_len, unsigned char* __restrict__ hit,
                     float* __restrict__ t_out, int* __restrict__ prim,
                     float* __restrict__ nx, float* __restrict__ ny,
                     float* __restrict__ nz) {
  extern __shared__ int smem[];
  __shared__ GroupScratch scratch;
  Slot s = slot<G>(ox, oy, oz, dx, dy, dz, active, n, stack_len, smem);
  Closest best;
  bool occ = false;
  group_walk<W, G, false>(nb, cm, ni, lt, s.r, s.act,
                          s.act ? tmax_in[s.i] : 0.0f, -1, &best, &occ,
                          s.stack_node, s.stack_mask, &scratch);
  if (s.i < n) {
    hit[s.i] = best.prim >= 0 ? 1 : 0;
    t_out[s.i] = best.t;
    prim[s.i] = best.prim;
    nx[s.i] = best.nx;
    ny[s.i] = best.ny;
    nz[s.i] = best.nz;
  }
}

template <int W, int G>
__global__ void __launch_bounds__(G < 128 ? 128 : G)
group_anyhit_kernel(const float* __restrict__ nb, const int* __restrict__ cm,
                    const int* __restrict__ ni, const float* __restrict__ lt,
                    const float* __restrict__ ox,
                    const float* __restrict__ oy,
                    const float* __restrict__ oz,
                    const float* __restrict__ dx,
                    const float* __restrict__ dy,
                    const float* __restrict__ dz,
                    const float* __restrict__ tmax_in,
                    const unsigned char* __restrict__ active,
                    const int* __restrict__ exclude, int n, int stack_len,
                    unsigned char* __restrict__ occ_out) {
  extern __shared__ int smem[];
  __shared__ GroupScratch scratch;
  Slot s = slot<G>(ox, oy, oz, dx, dy, dz, active, n, stack_len, smem);
  bool occ = false;
  group_walk<W, G, true>(nb, cm, ni, lt, s.r, s.act,
                         s.act ? tmax_in[s.i] : 0.0f,
                         s.act ? exclude[s.i] : -1, nullptr, &occ,
                         s.stack_node, s.stack_mask, &scratch);
  if (s.i < n) occ_out[s.i] = occ ? 1 : 0;
}

// The packet design: kPackets packets of kPacket rays per block.
constexpr int kPacketBlock = kPacket * kPackets;

struct PacketSlot {
  int i;
  bool act;
  Ray r;
  int pk;      // the packet's index in the block
  int* stack;  // its child-id stack
};

__device__ __forceinline__ PacketSlot packet_slot(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const unsigned char* __restrict__ active, int n, int stack_len,
    int* smem) {
  PacketSlot s;
  s.i = blockIdx.x * kPacketBlock + threadIdx.x;
  s.act = s.i < n && active[s.i];
  s.r = s.act ? load_ray(ox, oy, oz, dx, dy, dz, s.i)
              : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  s.pk = threadIdx.x / kPacket;
  s.stack = smem + stack_len * s.pk;
  return s;
}

template <int W>
__global__ void __launch_bounds__(kPacketBlock)
packet_closest_kernel(const float* __restrict__ nb,
                      const int* __restrict__ cm, const int* __restrict__ ni,
                      const float* __restrict__ lt,
                      const float* __restrict__ ox,
                      const float* __restrict__ oy,
                      const float* __restrict__ oz,
                      const float* __restrict__ dx,
                      const float* __restrict__ dy,
                      const float* __restrict__ dz,
                      const float* __restrict__ tmax_in,
                      const unsigned char* __restrict__ active, int n,
                      int stack_len, unsigned char* __restrict__ hit,
                      float* __restrict__ t_out, int* __restrict__ prim,
                      float* __restrict__ nx, float* __restrict__ ny,
                      float* __restrict__ nz) {
  extern __shared__ int smem[];
  __shared__ PacketShared<W> sh[kPackets];
  PacketSlot s = packet_slot(ox, oy, oz, dx, dy, dz, active, n, stack_len,
                             smem);
  Closest best;
  bool occ = false;
  packet_walk<W, false>(nb, cm, ni, lt, s.r, s.act,
                        s.act ? tmax_in[s.i] : 0.0f, -1, &best, &occ,
                        s.stack, sh[s.pk], s.pk);
  if (s.i < n) {
    hit[s.i] = best.prim >= 0 ? 1 : 0;
    t_out[s.i] = best.t;
    prim[s.i] = best.prim;
    nx[s.i] = best.nx;
    ny[s.i] = best.ny;
    nz[s.i] = best.nz;
  }
}

template <int W>
__global__ void __launch_bounds__(kPacketBlock)
packet_anyhit_kernel(const float* __restrict__ nb,
                     const int* __restrict__ cm, const int* __restrict__ ni,
                     const float* __restrict__ lt,
                     const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tmax_in,
                     const unsigned char* __restrict__ active,
                     const int* __restrict__ exclude, int n, int stack_len,
                     unsigned char* __restrict__ occ_out) {
  extern __shared__ int smem[];
  __shared__ PacketShared<W> sh[kPackets];
  PacketSlot s = packet_slot(ox, oy, oz, dx, dy, dz, active, n, stack_len,
                             smem);
  bool occ = false;
  packet_walk<W, true>(nb, cm, ni, lt, s.r, s.act,
                       s.act ? tmax_in[s.i] : 0.0f,
                       s.act ? exclude[s.i] : -1, nullptr, &occ, s.stack,
                       sh[s.pk], s.pk);
  if (s.i < n) occ_out[s.i] = occ ? 1 : 0;
}

// Raise ``Kernel``'s dynamic shared-memory cap to ``smem`` bytes on the
// current device where it is below; never lower it, so that a smaller
// launch between two larger ones leaves the larger cap in place.  A refused
// cap is returned and cleared, so that the next launch's
// cudaGetLastError() does not report it again.
template <auto Kernel>
int raise_smem_cap(int smem) {
  constexpr int kDevices = 16;
  static int cap[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem <= cap[dev]) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  cap[dev] = smem;
  return 0;
}

// One block per kPackets packets; each packet's stack is ``stack_len``
// ints of dynamic shared memory.
template <auto Kernel, typename... Args>
int launch_packet(int n, int stack_len, cudaStream_t stream, Args... args) {
  const int blocks = (n + kPacketBlock - 1) / kPacketBlock;
  const int smem = kPackets * stack_len * (int)sizeof(int);
  const int rc = raise_smem_cap<Kernel>(smem);
  if (rc != 0) return rc;
  Kernel<<<blocks, kPacketBlock, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The leader design: one block per packet or per four lane groups; each
// group's stack is 2 * stack_len ints of dynamic shared memory.
template <typename K, typename... Args>
int launch(K kernel, int block, int group, int n, int stack_len,
           cudaStream_t stream, Args... args) {
  int groups = (n + group - 1) / group;
  int per_block = block / group;
  int blocks = (groups + per_block - 1) / per_block;
  size_t smem = (size_t)per_block * 2 * stack_len * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The lane design: kLaneWarps warps a block where their shared memory fits
// the card's opt-in limit, fewer for deeper trees (``stack_len`` child ids
// a warp), as many blocks as the card keeps resident, capped by the groups.
template <int W, bool ANY>
int launch_lane(const Tables& tb, const Rays& rays, int n,
                const LaneOuts& out, unsigned* work, int stack_len,
                cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (stack_len <= 0 || stack_len > optin / 4 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_warp = lane_warp_bytes<W>(stack_len);
  const int warps = kLaneWarps < optin / per_warp ? kLaneWarps
                                                  : optin / per_warp;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = warps * per_warp;
  const int rc = raise_smem_cap<lane_kernel<W, ANY>>(smem);
  if (rc != 0) return rc;
  const int grid = fetch_grid<lane_kernel<W, ANY>>(n, smem, warps * kLane);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidDevice);
  lane_kernel<W, ANY><<<grid, warps * kLane, smem, s>>>(tb, rays, n, out,
                                                        work, stack_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool ANY>
int lane_entry(int width, int group, int stack_len, const Tables& tb,
               const Rays& rays, int n, const LaneOuts& out, unsigned* work,
               void* stream) {
  if (group != kLane) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8)
    return launch_lane<8, ANY>(tb, rays, n, out, work, stack_len, s);
  if (width == 16)
    return launch_lane<16, ANY>(tb, rays, n, out, work, stack_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int G>
int closest(int width, int stack_len, const float* nb, const int* cm,
            const int* ni, const float* lt, const float* ox, const float* oy,
            const float* oz, const float* dx, const float* dy,
            const float* dz, const float* tmax, const unsigned char* active,
            int n, unsigned char* hit, float* t, int* prim, float* nx,
            float* ny, float* nz, void* stream) {
  if (n <= 0) return 0;
  if (stack_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int block = block_threads<G>();
  if (width == 8)
    return launch(group_closest_kernel<8, G>, block, G, n, stack_len, s, nb,
                  cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, n,
                  stack_len, hit, t, prim, nx, ny, nz);
  if (width == 16)
    return launch(group_closest_kernel<16, G>, block, G, n, stack_len, s, nb,
                  cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, n,
                  stack_len, hit, t, prim, nx, ny, nz);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int G>
int anyhit(int width, int stack_len, const float* nb, const int* cm,
           const int* ni, const float* lt, const float* ox, const float* oy,
           const float* oz, const float* dx, const float* dy, const float* dz,
           const float* tmax, const unsigned char* active, const int* exclude,
           int n, unsigned char* occ, void* stream) {
  if (n <= 0) return 0;
  if (stack_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int block = block_threads<G>();
  if (width == 8)
    return launch(group_anyhit_kernel<8, G>, block, G, n, stack_len, s, nb,
                  cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, exclude,
                  n, stack_len, occ);
  if (width == 16)
    return launch(group_anyhit_kernel<16, G>, block, G, n, stack_len, s, nb,
                  cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, exclude,
                  n, stack_len, occ);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The leader design.  ``group`` is the caller's group size; it must be the
// one compiled here (kernels/wide.py LEADER_PACKET, kernels/lane.py LANE),
// so that the plain version walks the same groups.
#define RTJAX_GROUP_ENTRIES(NAME, G)                                          \
  extern "C" int rtjax_##NAME##_closest(                                      \
      int width, int group, int stack_len, const float* nb, const int* cm,    \
      const int* ni, const float* lt, const float* ox, const float* oy,       \
      const float* oz, const float* dx, const float* dy, const float* dz,     \
      const float* tmax, const unsigned char* active, int n,                  \
      unsigned char* hit, float* t, int* prim, float* nx, float* ny,          \
      float* nz, void* stream) {                                              \
    if (group != G) return static_cast<int>(cudaErrorInvalidValue);           \
    return closest<G>(width, stack_len, nb, cm, ni, lt, ox, oy, oz, dx, dy,   \
                      dz, tmax, active, n, hit, t, prim, nx, ny, nz, stream); \
  }                                                                           \
  extern "C" int rtjax_##NAME##_anyhit(                                       \
      int width, int group, int stack_len, const float* nb, const int* cm,    \
      const int* ni, const float* lt, const float* ox, const float* oy,       \
      const float* oz, const float* dx, const float* dy, const float* dz,     \
      const float* tmax, const unsigned char* active, const int* exclude,     \
      int n, unsigned char* occ, void* stream) {                              \
    if (group != G) return static_cast<int>(cudaErrorInvalidValue);           \
    return anyhit<G>(width, stack_len, nb, cm, ni, lt, ox, oy, oz, dx, dy,    \
                     dz, tmax, active, exclude, n, occ, stream);              \
  }

RTJAX_GROUP_ENTRIES(packet_leader, kLeaderPacket)
RTJAX_GROUP_ENTRIES(lane_group, kLane)

// The lane design.  ``group`` must be kLane (kernels/lane.py LANE);
// ``stack_len`` is each warp's child-id stack, (depth + 1) * (width - 1)
// entries (kernels/lane.py lane_stack_len); ``work``: the persist kernels'
// two zeroed unsigned words per device and stream, left zeroed.
extern "C" int rtjax_lane_closest(
    int width, int group, int stack_len, const float* nb, const int* cm,
    const int* ni, const float* lt, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* tmax, const unsigned char* active, int n, unsigned char* hit,
    float* t, int* prim, float* nx, float* ny, float* nz, unsigned* work,
    void* stream) {
  return lane_entry<false>(width, group, stack_len, {nb, cm, ni, lt},
                     {ox, oy, oz, dx, dy, dz, tmax, active, nullptr}, n,
                     {hit, t, prim, nx, ny, nz}, work, stream);
}

extern "C" int rtjax_lane_anyhit(
    int width, int group, int stack_len, const float* nb, const int* cm,
    const int* ni, const float* lt, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* tmax, const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, unsigned* work, void* stream) {
  return lane_entry<true>(width, group, stack_len, {nb, cm, ni, lt},
                    {ox, oy, oz, dx, dy, dz, tmax, active, exclude}, n,
                    {occ, nullptr, nullptr, nullptr, nullptr, nullptr}, work,
                    stream);
}

// The packet design.  ``group`` must be kPacket (kernels/wide.py PACKET);
// ``stack_len`` is each packet's child-id stack, (depth + 1) * (width - 1)
// entries (kernels/wide.py packet_stack_len).
extern "C" int rtjax_packet_closest(
    int width, int group, int stack_len, const float* nb, const int* cm,
    const int* ni, const float* lt, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* tmax, const unsigned char* active, int n, unsigned char* hit,
    float* t, int* prim, float* nx, float* ny, float* nz, void* stream) {
  if (group != kPacket || stack_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8)
    return launch_packet<packet_closest_kernel<8>>(
        n, stack_len, s, nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active,
        n, stack_len, hit, t, prim, nx, ny, nz);
  if (width == 16)
    return launch_packet<packet_closest_kernel<16>>(
        n, stack_len, s, nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active,
        n, stack_len, hit, t, prim, nx, ny, nz);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rtjax_packet_anyhit(
    int width, int group, int stack_len, const float* nb, const int* cm,
    const int* ni, const float* lt, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* tmax, const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, void* stream) {
  if (group != kPacket || stack_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8)
    return launch_packet<packet_anyhit_kernel<8>>(
        n, stack_len, s, nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active,
        exclude, n, stack_len, occ);
  if (width == 16)
    return launch_packet<packet_anyhit_kernel<16>>(
        n, stack_len, s, nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active,
        exclude, n, stack_len, occ);
  return static_cast<int>(cudaErrorInvalidValue);
}
