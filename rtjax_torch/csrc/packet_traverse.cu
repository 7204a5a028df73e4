// Packet and lane BVH traversal for Hopper (sm_90a): closest hit and any
// hit over the wide-node tables of rtjax_torch/accel/wide.py, with one
// shared cursor per group of rays.
//
// Replaces: rtjax/kernels/pallas_wide.py, wide_traverse_closest
// (_make_closest_kernel) and wide_traverse_anyhit (_make_anyhit_kernel),
// a 2048-ray tile per walk; rtjax/kernels/pallas_lane.py,
// lane_traverse_closest (_make_lane_closest_kernel) and
// lane_traverse_anyhit (_make_lane_anyhit_kernel), a 128-ray sublane per
// walk.  Both compute one function in two schedules, so here they are one
// group walk (group_walk.cuh) at two group sizes: a packet is one CTA of
// kPacket rays (a CTA holds at most 1024 threads, so the TPU's 2048-ray
// tile does not carry over), a lane group is one warp.
//
// What bounds it on this card: as for the persist kernels, the latency of
// the dependent node-row loads, plus here the group's barrier per step and
// the union of its rays' node sets: every ray of a group pays for every
// node any of them needs.  The tables of the headline scene stay resident
// in the 50 MB L2; the tensor cores have nothing to do.
//
// What the design does about it: all threads of a group load the same node
// row, which the read-only path broadcasts; each thread slab-tests with its
// own tmax and tests only the leaves its own slab accepted, so a ray that
// has found a near hit stops paying for leaf tests behind it.  The group
// reduces W-bit masks with warp votes (and shared memory across a CTA), and
// one leader thread keeps the group's stack in shared memory.  rtjax's
// deferred leaf queue, interleaved cursors and work-stealing stack hide the
// TPU's vector->scalar latency and have no counterpart here.
//
// Exactness: the build uses --fmad=false, so each product and sum rounds
// like the separate torch ops of the plain version (kernels/wide.py), which
// walks the same order; results agree bit for bit.

#include <cuda_runtime.h>

#include "group_walk.cuh"

namespace {

using rtjax::Closest;
using rtjax::GroupScratch;
using rtjax::Ray;
using rtjax::group_walk;
using rtjax::load_ray;
using rtjax::make_ray;

constexpr int kPacket = 256;  // rays per packet (one CTA)
constexpr int kLane = 32;     // rays per lane group (one warp)

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

// One block per packet or per four lane groups; each group's stack is
// 2 * stack_len ints of dynamic shared memory.
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

// ``group`` is the caller's group size; it must be the one compiled here
// (kernels/wide.py PACKET, kernels/lane.py LANE), so that the plain version
// walks the same groups.
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

RTJAX_GROUP_ENTRIES(packet, kPacket)
RTJAX_GROUP_ENTRIES(lane, kLane)
