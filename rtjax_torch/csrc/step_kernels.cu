// The fused wavefront step for Hopper (sm_90a): route, shade and resolve,
// the kernels of one iteration around one torch.sort
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

// at least one block an SM: ptxas then takes 85 registers, not 84, and
// the kernel runs 10% faster (PERF.md)
__global__ void __launch_bounds__(kShadeBlock, 1)
    shade_kernel(const StepArgs a) {
  __shared__ SmemTables smem;
  const Tables T = stage_tables(a, smem);
  const int i = blockIdx.x * kShadeBlock + threadIdx.x;
  const bool do_gen = rtjax_step::cadence(a);
  rtjax_step::ShadeLane r = {};
  if (i < a.n) {
    r = rtjax_step::shade_lane<false>(a, i, T, do_gen);
    const long long lo = a.counts[0];
    if (r.flush && i >= lo && i < lo + a.counts[4]) {
      const rtjax_step::V3 v = r.flushed;
      float* px = a.fb + 3 * static_cast<long long>(r.pixel);
      if (v.x != 0.0f) atomicAdd(px, v.x);
      if (v.y != 0.0f) atomicAdd(px + 1, v.y);
      if (v.z != 0.0f) atomicAdd(px + 2, v.z);
    }
  }
  count(a.counts + 1, r.trace);
  count(a.counts + 2, r.nee);
  count(a.counts + 3, r.mis);
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

__global__ void __launch_bounds__(kBlock) resolve_kernel(const StepArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < a.n && a.num_lights > 0) rtjax_step::resolve_lane(a, i);
  if (i == 0) rtjax_step::resolve_counters(a);
}

int grid_of(int n, int block) { return (n + block - 1) / block; }

template <typename Kernel>
int launch(Kernel kernel, int block, const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  kernel<<<grid_of(a->n, block), block, 0,
           static_cast<cudaStream_t>(stream)>>>(*a);
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

// A kernel's registers, local bytes a thread, threads a block and
// resident blocks an SM (kernels/step.py KERNEL_IDS: 0 route, 1 shade, 2
// resolve, 3 route_v1, 4 shade_v1).
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
