// The tiny-scene direct path for Hopper (sm_90a): closest hit and any hit
// of every ray against every triangle of a small mesh, no BVH.
//
// Replaces: rtjax/render/trace.py, _direct_closest and _direct_anyhit --
// not Pallas kernels but an unrolled all-triangles Moeller-Trumbore loop
// that XLA fuses into the surrounding iteration.  rtjax takes it for every
// single-level launch over a mesh of at most ``direct_max_tris`` (default
// 64) triangles; so does the port (render/trace.py ``_backend``).
//
// What bounds it on this card (PERF.md, the direct pair; config 2's 2^19
// camera rays and 2^20 shadow lanes x 12 triangles):
// - bytes: each ray's flag and results once, an active ray's inputs once,
//   48 bytes a triangle: ~8 / ~3.4 us at 3.35 TB/s.  The launch with every
//   lane inactive (its flags read, its misses written) already takes 8-10
//   us: a third of closest hit's time and half of any hit's;
// - issue slots: ~75 instructions a ray and triangle (with --fmad=false
//   each of the test's ~42 float operations issues alone, and the IEEE
//   reciprocal takes ~10), at one instruction a clock a scheduler: the
//   rest of closest hit's time.  Triangle operands read as uniform
//   constants (a parameter block) took as many ULDC as the loads they
//   replaced and were slower in the frame; rejecting on t first saves
//   nothing where a warp's lanes do not all reject;
// - idle lanes: a shadow lane is live only where its path sampled a light
//   (28% of config 2's second launch, more scattered in later launches).
//
// The closest-hit kernel is the first design: one thread a ray, the
// triangles staged in shared memory 64 at a time, every test in full --
// the fastest of the designs tried in a captured config-2 frame (PERF.md).
// The any-hit kernel compacts live lanes in the block: a block takes a
// window of kWindow (2 x 128) lanes, ballots their ``active`` flags,
// writes the live lanes' indices in order to shared memory (each warp's
// __popc and the block's offsets) and runs the triangle loop over that
// dense list, so a warp's lanes are live but in the window's last warp
// and an early exit retires whole warps; dead lanes get 0 where their
// flags are read.  It stages 48-byte triangle records (three 16-byte
// loads a test) and rejects on t first (direct_math.cuh anyhit_test).
// Its first design stays as the ``_v1`` entry point for same-run A/B.
//
// Exactness: the build uses --fmad=false and every test keeps
// core/geometry.py intersect_triangle_v3's operation order
// (direct_math.cuh), so every lane agrees bit for bit with the plain
// versions (kernels/direct.py) and with rtjax's loop.  The triangles go in
// leaf order with a strict t < best, so the kept one is the first of least
// t; a lane's loop is the same whatever lanes share its warp.

#include <cuda_runtime.h>

#include "direct_math.cuh"

namespace {

using namespace rtjax_direct;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kPerThread = 2;                  // window lanes a thread
constexpr int kWindow = kPerThread * kBlock;   // lanes a block compacts
constexpr int kMinBlocks = 8;                  // resident blocks an SM
constexpr int kTile = 64;                      // triangles a shared tile

struct Tris {
  const float* p0;  // [T, 3] each
  const float* e1;
  const float* e2;
  const float* n;
  int num;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* tmax;
  const unsigned char* active;
  const int* exclude;  // any hit only
};

struct ClosestOut {
  unsigned char* hit;
  float* t;
  int* prim;
  float *nx, *ny, *nz;
};

__device__ __forceinline__ Ray load_ray(const Rays& rays, int i) {
  return Ray{rays.ox[i], rays.oy[i], rays.oz[i], rays.dx[i],
             rays.dy[i], rays.dz[i], rays.tmax[i]};
}

__device__ __forceinline__ void write_hit(const ClosestOut& o, int i,
                                          const Hit& h) {
  o.hit[i] = h.prim >= 0 ? 1 : 0;
  o.t[i] = h.best;
  o.prim[i] = h.prim;
  o.nx[i] = h.nx;
  o.ny[i] = h.ny;
  o.nz[i] = h.nz;
}

// The block's window: the live lanes' indices in order, and each
// (thread slot, warp)'s live count.
struct Window {
  int list[kWindow];
  int counts[kPerThread * kWarps];
};

// Compact window ``base``: lane base + j * kBlock + threadIdx.x is thread
// slot j's, so the order (j, warp, lane in warp) is the lanes' order.
// ``dead(i)`` runs for each lane of the window below n that is not
// active.  Returns the live count; the list is ready (synchronised).
template <class Dead>
__device__ __forceinline__ int compact(Window& w, const unsigned char* active,
                                       int n, int base, Dead dead) {
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  unsigned ballot[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kBlock + threadIdx.x;
    const bool in = i < n;
    const bool live = in && active[i] != 0;
    if (in && !live) dead(i);
    ballot[j] = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0)
      w.counts[j * kWarps + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  int total = 0;
  int off[kPerThread] = {};
#pragma unroll
  for (int s = 0; s < kPerThread * kWarps; ++s) {
    if (s % kWarps == warp) off[s / kWarps] = total;
    total += w.counts[s];
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if ((ballot[j] >> (threadIdx.x & 31)) & 1u)
      w.list[off[j] + __popc(ballot[j] & below)] =
          base + j * kBlock + threadIdx.x;
  }
  __syncthreads();
  return total;
}

// Stage triangles base .. base + count - 1 (count <= kTile) as records;
// the caller synchronises before and after.
__device__ __forceinline__ void stage(Tri* tile, const Tris& tr, int base,
                                      int count) {
  float* dst = reinterpret_cast<float*>(tile);
  for (int j = threadIdx.x; j < 12 * count; j += kBlock) {
    const int k = j / 12, f = j - 12 * k, field = f / 3;
    const float* src = field == 0 ? tr.p0 : field == 1 ? tr.e1
                     : field == 2 ? tr.e2 : tr.n;
    dst[j] = __ldg(src + 3 * (base + k) + f % 3);
  }
}

// ------------------------------------------------------------ any hit

// Live lanes compacted, the block's dense list in rounds of kBlock rays,
// each round over every tile.
__global__ void __launch_bounds__(kBlock, kMinBlocks)
anyhit_kernel(const Tris tr, const Rays rays, const int n,
              unsigned char* __restrict__ occ_out) {
  __shared__ Window w;
  __shared__ Tri tile[kTile];
  const int total = compact(w, rays.active, n, blockIdx.x * kWindow,
                            [&](int i) { occ_out[i] = 0; });
  for (int round = 0; round * kBlock < total; ++round) {
    const int idx = round * kBlock + threadIdx.x;
    const bool live = idx < total;
    const int i = live ? w.list[idx] : 0;
    Ray r{};
    int exclude = -1;
    if (live) {
      r = load_ray(rays, i);
      exclude = rays.exclude[i];
    }
    bool occ = false;
    for (int base = 0; base < tr.num; base += kTile) {
      // also the barrier before staging: stop once no ray of the round is
      // still looking
      if (!__syncthreads_or(live && !occ)) break;
      const int count = min(kTile, tr.num - base);
      stage(tile, tr, base, count);
      __syncthreads();
      if (!live || occ) continue;
      for (int k = 0; k < count; ++k) {
        if (base + k != exclude && anyhit_test(tile[k], r)) {
          occ = true;
          break;
        }
      }
    }
    if (live) occ_out[i] = occ ? 1 : 0;
  }
}

// ----------------------------------------- closest hit; the first design

constexpr int kTileV1 = 64;

// One tile of triangles in shared memory, [kTileV1, 3] a field.
struct TileV1 {
  float p0[3 * kTileV1], e1[3 * kTileV1], e2[3 * kTileV1], n[3 * kTileV1];
};

__device__ __forceinline__ void stage_v1(TileV1& s, const Tris& tr, int base,
                                         int count) {
  const int off = 3 * base;
  for (int j = threadIdx.x; j < 3 * count; j += kBlock) {
    s.p0[j] = __ldg(tr.p0 + off + j);
    s.e1[j] = __ldg(tr.e1 + off + j);
    s.e2[j] = __ldg(tr.e2 + off + j);
    s.n[j] = __ldg(tr.n + off + j);
  }
}

// One thread a ray over the whole launch, every test in full: closest hit
// on the engine's path, any hit (anyhit_kernel_v1) for same-run A/B.
__global__ void __launch_bounds__(kBlock)
closest_kernel(const Tris tr, const Rays rays, const int n,
               const ClosestOut out) {
  __shared__ TileV1 s;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n && rays.active[i] != 0;
  Ray r{};
  if (live) r = load_ray(rays, i);
  Hit h = no_hit();
  for (int base = 0; base < tr.num; base += kTileV1) {
    const int count = min(kTileV1, tr.num - base);
    __syncthreads();
    stage_v1(s, tr, base, count);
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < count; ++k) {
      float t;
      if (mt_full(s.p0 + 3 * k, s.e1 + 3 * k, s.e2 + 3 * k, s.n + 3 * k, r,
                  &t) && t < h.best) {
        h.best = t;
        h.prim = base + k;
        h.nx = s.n[3 * k];
        h.ny = s.n[3 * k + 1];
        h.nz = s.n[3 * k + 2];
      }
    }
  }
  if (i < n) write_hit(out, i, h);  // an inactive lane keeps the miss
}

__global__ void __launch_bounds__(kBlock)
anyhit_kernel_v1(const Tris tr, const Rays rays, const int n,
                 unsigned char* __restrict__ occ_out) {
  __shared__ TileV1 s;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n && rays.active[i] != 0;
  Ray r{};
  int exclude = -1;
  if (live) {
    r = load_ray(rays, i);
    exclude = rays.exclude[i];
  }
  bool occ = false;
  for (int base = 0; base < tr.num; base += kTileV1) {
    if (!__syncthreads_or(live && !occ)) break;
    const int count = min(kTileV1, tr.num - base);
    stage_v1(s, tr, base, count);
    __syncthreads();
    if (!live || occ) continue;
    for (int k = 0; k < count; ++k) {
      float t;
      if (mt_full(s.p0 + 3 * k, s.e1 + 3 * k, s.e2 + 3 * k, s.n + 3 * k, r,
                  &t) && base + k != exclude) {
        occ = true;
        break;
      }
    }
  }
  if (i < n) occ_out[i] = occ ? 1 : 0;
}

int grid_of(int n, int lanes) { return (n + lanes - 1) / lanes; }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// ``num_tris`` triangles (leaf order, [T, 3] float32 each), ``n`` rays as
// SoA columns; results as the plain versions give them (kernels/direct.py).
// Returns the launch's CUDA error code (0 when queued).
extern "C" int rtjax_direct_closest(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num_tris, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    int* prim, float* nx, float* ny, float* nz, void* stream) {
  if (n <= 0) return 0;
  if (num_tris < 0) return invalid();
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, nullptr};
  closest_kernel<<<grid_of(n, kBlock), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      Tris{p0, e1, e2, nrm, num_tris}, rays, n,
      ClosestOut{hit, t, prim, nx, ny, nz});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtjax_direct_anyhit(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num_tris, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, void* stream) {
  if (n <= 0) return 0;
  if (num_tris < 0) return invalid();
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, exclude};
  anyhit_kernel<<<grid_of(n, kWindow), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      Tris{p0, e1, e2, nrm, num_tris}, rays, n, occ);
  return static_cast<int>(cudaGetLastError());
}

// The first design of any hit, kept for same-run A/B: one thread a ray.
extern "C" int rtjax_direct_anyhit_v1(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num_tris, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, void* stream) {
  if (n <= 0) return 0;
  if (num_tris < 0) return invalid();
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, exclude};
  anyhit_kernel_v1<<<grid_of(n, kBlock), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      Tris{p0, e1, e2, nrm, num_tris}, rays, n, occ);
  return static_cast<int>(cudaGetLastError());
}
