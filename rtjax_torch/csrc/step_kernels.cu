// The fused wavefront step for Hopper (sm_90a): route, shade and resolve,
// the three kernels of one iteration around one torch.sort
// (kernels/step.py; the lanes' math in step_math.cuh).
//
// Replaces: rtjax/render/wavefront.py wavefront_step (:187-818) -- no
// Pallas kernel but one jitted XLA program, whose per-lane stages XLA
// fuses into a few loops around its lax.sort: route (:212-262 and the key
// and pack half of :263-436), shade (:437-747) and resolve (:748-818).
//
// What bounds them on this card: bytes.  Each lane does some hundreds of
// float operations (shade: two BSDF samples, a light sample, a ray-
// triangle test, a camera ray) against 120-250 bytes of state and random
// words read and written once; at 67 TFLOP/s against 3.35 TB/s the bytes
// take longer.  The counts: route reads a slot's state (73 B) and its word
// (8 B) and writes its key and bundle (40 B); shade reads its order (8 B),
// the bundle through it (36 B), four words (32 B) and writes the next
// state (45 B), the traced flag and two shadow rays with their radiance
// (2 x 38 B + 24 B); resolve reads the radiance, the two channels'
// radiance, masks and occlusion (40 B) and writes the radiance (12 B).
//
// What the design does about it: one thread a slot, every column read and
// written as [n] SoA arrays so that loads coalesce (the bundle's gather by
// the sort's order is the one scattered read), nothing but the bundle and
// the shadow columns kept between kernels, and the counts reduced in the
// block (__syncthreads_count) to one 64-bit atomic a block.  A lane takes
// only its material's and its light's branch of the plain version's
// branchless code: the selected value is the same, and the others are not
// computed.  The framebuffer flush is a float atomicAdd, as index_add_ is
// on the card.

#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

using rtjax_step::StepArgs;

constexpr int kBlock = 256;

__device__ __forceinline__ void count(long long* c, bool pred) {
  const int k = __syncthreads_count(pred);
  if (threadIdx.x == 0 && k != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(c),
              static_cast<unsigned long long>(k));
}

__global__ void __launch_bounds__(kBlock) route_kernel(const StepArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool mat = i < a.n && rtjax_step::route_lane(a, i);
  count(a.counts, mat);
}

__global__ void __launch_bounds__(kBlock) shade_kernel(const StepArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  rtjax_step::ShadeLane r = {};
  if (i < a.n) {
    r = rtjax_step::shade_lane(a, i);
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

__global__ void __launch_bounds__(kBlock) resolve_kernel(const StepArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < a.n && a.num_lights > 0) rtjax_step::resolve_lane(a, i);
  if (i == 0) rtjax_step::resolve_counters(a);
}

int grid_of(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// The entry points take the argument block (kernels/step.py StepArgs) and
// torch's current stream; each returns the launch's CUDA error code (0
// when queued).  route needs counts zeroed; shade the counts route left;
// resolve the counts shade left.
extern "C" int rtjax_step_route(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  route_kernel<<<grid_of(a->n), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtjax_step_shade(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  shade_kernel<<<grid_of(a->n), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtjax_step_resolve(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  resolve_kernel<<<grid_of(a->n), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
