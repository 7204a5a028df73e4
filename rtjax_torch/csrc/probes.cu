// The TPU probes' counterparts for Hopper (sm_90a): the no-op launch of
// benchmarks/stage_bench.py and the walk primitives of
// benchmarks/micro_kernel.py, each timed by the two-point slope of its
// in-kernel iterations (rtjax_torch/probes/).  kernels/probes.py binds
// them; the loop bodies are probes.cuh's.
//
// Replaces:
// - benchmarks/stage_bench.py:123, main's nop_launch (nop_kernel,
//   :116-117): copy_kernel, a copy of a [16, 128] f32 tile, and
//   sum_kernel, the jnp.sum around it, one block a tile;
// - benchmarks/micro_kernel.py:106, make_scalar_walk: scalar_walk_kernel,
//   one thread's dependent chain, the meta table in global memory (4 KB,
//   L1-resident) read by __ldg, the 64-entry stack in shared memory;
// - benchmarks/micro_kernel.py:59, _smem_out_call, launching
//   _make_slab_step (:117), _make_slab_step_row1 (:152),
//   _make_slab_step_fused (:190), make_leaf_mt_vpu (:239) and
//   make_leaf_mt_vpu_nodiv (:298): tile_kernel<V>, one instance a probe
//   (the division-free one as tile_kernel_1block<V>, one block an SM);
// - benchmarks/micro_kernel.py:777, make_clz: clz_kernel, one thread's
//   loop on __clz;
// - benchmarks/micro_kernel.py:387, :457, :529, :602, the tensor-core leaf
//   tests make_leaf_mt_mxu (:359), _full (:397), _pair (:466) and _group
//   (:538): mxu_kernel<V>, one instance a probe (mxu_probes.cuh, on
//   mma.sync: bf16, one TF32 pass or 3xTF32; bound by the tensor cores'
//   share of the product or the issue of the accept).
//
// What bounds them on this card: the issue of each iteration's
// instructions (the tile probes: 4 warp-instructions a clock on one SM),
// or for the two chains the latency of a step (a load, a shared-memory
// store and load, and the selects that depend on them); the copy and the
// sum, a launch's fixed cost (16 KB moved is 4.9 ns at 3.35 TB/s).
//
// The design:
// - a TPU probe is one core looping over one 2,048-lane tile.  Here a
//   block of 256 threads computes one tile, 8 lanes a thread, and loops
//   n times; it sums its lanes' checksum with warp shuffles and shared
//   memory and writes one uint32 a tile.  The one-tile grid is one block
//   (one SM: a step's latency and issue cost); the full card is every SM
//   times its resident blocks, each computing the same tile (the card's
//   rate), and every tile must write the same checksum;
// - every lane of an iteration reads the same table row (micro_kernel.py
//   _bcast, a lane broadcast on the TPU).  UniformRow reads it as the
//   walks read a node row: every thread loads the same 16 bytes from
//   global memory (the 512 KB table stays in L2), one transaction a warp.
//   The TPU's row1 probes (:152, :245-246) take the card's other
//   broadcast, ShflRow: each lane of a warp loads one value of the row
//   (coalesced) and __shfl_sync hands each value to every lane;
// - the chains' full card is one chain a thread, all on the same table,
//   so that one launch gives the latency (one tile: one thread) and the
//   throughput of independent chains (every thread of the card);
// - the iteration loops are not unrolled (#pragma unroll 1), so that an
//   iteration's instructions are one loop body in the SASS, which
//   rtjax_torch/probes counts for the bound.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "mxu_probes.cuh"
#include "probes.cuh"

using namespace rtjax_probes;

namespace {

constexpr int kChainBlock = 128;   // threads a block of the chains' grid
constexpr int kCopyThreads = 256;  // a tile's copy and sum: 8 floats each

// the copy's programmatic dependent launch: wait for the grid before to
// finish (its writes visible), then let the next one be scheduled
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// a block's sum of one value a thread, written by thread 0 (blockDim.x a
// multiple of 32, at most 1024)
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T part[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? part[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// ------------------------------------------------------------- no-op launch
template <bool kPdl>
__global__ void __launch_bounds__(kCopyThreads)
    copy_kernel(const float4* __restrict__ x, float4* __restrict__ y) {
  if (kPdl) {
    wait_for_previous();
    launch_dependents();
  }
  const int base = blockIdx.x * (kTileLanes / 4);
#pragma unroll
  for (int k = 0; k < kTileLanes / 4 / kCopyThreads; ++k) {
    const int i = base + k * kCopyThreads + threadIdx.x;
    y[i] = x[i];
  }
}

__global__ void __launch_bounds__(kCopyThreads)
    sum_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const float* tile = x + static_cast<long long>(blockIdx.x) * kTileLanes;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kTileLanes / kCopyThreads; ++k)
    s += tile[k * kCopyThreads + threadIdx.x];
  s = block_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// ------------------------------------------------------------- the chains
// a thread's 64 stack entries in shared memory, entry k at k * stride
struct SmemStack {
  int* base;
  int stride;
  __device__ __forceinline__ int get(int k) const { return base[k * stride]; }
  __device__ __forceinline__ void set(int k, int v) { base[k * stride] = v; }
};

__global__ void __launch_bounds__(kChainBlock)
    scalar_walk_kernel(const int* __restrict__ meta,
                       unsigned* __restrict__ out, int n, int chains) {
  extern __shared__ int stack[];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  SmemStack s{stack + threadIdx.x, static_cast<int>(blockDim.x)};
  out[c] = scalar_walk(meta, s, n);
}

__global__ void __launch_bounds__(kChainBlock)
    clz_kernel(unsigned* __restrict__ out, int n, int chains) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < chains) out[c] = clz_chain(n);
}

// ------------------------------------------------------------ tile probes
// the row broadcast to every lane: each thread loads the same 16 bytes
struct UniformRow {
  const float4* row;
  __device__ __forceinline__ explicit UniformRow(const float* r)
      : row(reinterpret_cast<const float4*>(r)) {}
  __device__ __forceinline__ float4 load4(int q) const {
    return __ldg(row + q);
  }
};

// the row1 probes' broadcast: lane l of each warp loads the row's values
// l, 32 + l, ... (kWords of them, coalesced), and __shfl_sync hands value
// k from lane k % 32 to every lane
template <int kValues>
struct ShflRow {
  static constexpr int kWords = (kValues + 31) / 32;
  float v[kWords];
  __device__ __forceinline__ explicit ShflRow(const float* r) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int w = 0; w < kWords; ++w) v[w] = __ldg(r + 32 * w + lane);
  }
  __device__ __forceinline__ float at(int k) const {
    return __shfl_sync(0xffffffffu, v[k >> 5], k & 31);
  }
  __device__ __forceinline__ float4 load4(int q) const {
    return make_float4(at(4 * q), at(4 * q + 1), at(4 * q + 2),
                       at(4 * q + 3));
  }
};

template <int V>
using RowOf = typename std::conditional<
    Probe<V>::kRow1, ShflRow<Probe<V>::Body::kRowValues>, UniformRow>::type;

// The division-free leaf test keeps each lane's best hit (bat, badet,
// bprim) beside its ray: ~200 registers.  ptxas holds a 256-thread kernel
// to 128 for two blocks an SM, and spilled it there; it gets one block an
// SM instead, so that it runs from registers as every other probe does.
template <int V>
constexpr bool kOneBlock = V == kLeafMtNodiv;

template <int V>
__device__ __forceinline__ void tile(const float* table, const float* rays,
                                     unsigned* out, int n) {
  const unsigned s = block_sum(
      tile_thread<typename Probe<V>::Body, RowOf<V>>(table, rays,
                                                     threadIdx.x, n));
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <int V>
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const float* __restrict__ table,
                const float* __restrict__ rays, unsigned* __restrict__ out,
                int n) {
  tile<V>(table, rays, out, n);
}

template <int V>
__global__ void __launch_bounds__(kTileThreads, 1)
    tile_kernel_1block(const float* __restrict__ table,
                       const float* __restrict__ rays,
                       unsigned* __restrict__ out, int n) {
  tile<V>(table, rays, out, n);
}

template <int V>
const void* tile_function_of() {
  if constexpr (kOneBlock<V>)
    return reinterpret_cast<const void*>(tile_kernel_1block<V>);
  else
    return reinterpret_cast<const void*>(tile_kernel<V>);
}

template <int V>
cudaError_t launch_tile(const float* table, const float* rays,
                        unsigned* out, int n, int tiles, cudaStream_t s) {
  if constexpr (kOneBlock<V>)
    tile_kernel_1block<V><<<tiles, kTileThreads, 0, s>>>(table, rays, out,
                                                          n);
  else
    tile_kernel<V><<<tiles, kTileThreads, 0, s>>>(table, rays, out, n);
  return cudaGetLastError();
}

using TileLaunch = cudaError_t (*)(const float*, const float*, unsigned*,
                                   int, int, cudaStream_t);

template <int... Vs>
TileLaunch tile_launch(int v, std::integer_sequence<int, Vs...>) {
  TileLaunch table[] = {launch_tile<Vs>...};
  return table[v];
}

template <int... Vs>
const void* tile_function(int v, std::integer_sequence<int, Vs...>) {
  const void* table[] = {tile_function_of<Vs>()...};
  return table[v];
}

using AllVariants = std::make_integer_sequence<int, kVariants>;

// ---------------------------------------------------- tensor-core probes
// the card's warp for mxu_probes.cuh: its lane, shuffles and mma.sync
struct CardWarp {
  __device__ __forceinline__ int lane() const { return threadIdx.x & 31; }
  __device__ __forceinline__ float shfl_xor(float v, int m) const {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
  __device__ __forceinline__ int shfl_xor(int v, int m) const {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
  __device__ __forceinline__ float shfl(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  // d += a · b, m16n8k16, bf16 operands, f32 accumulator
  __device__ __forceinline__ void mma_bf16(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) const {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  // d += a · b, m16n8k8, TF32 operands, f32 accumulator
  __device__ __forceinline__ void mma_tf32(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) const {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};

// A tensor-core probe: one block a tile, 8 warps of 256 rays each, n
// iterations (mxu_probes.cuh mxu_warp); block b writes out[b] (2,048
// floats) and, when ``fields`` is not null, fields[b] (Mxu<V>::kOut rows
// of 2,048).
template <int V>
__global__ void __launch_bounds__(kTileThreads)
    mxu_kernel(const void* __restrict__ table,
               const void* __restrict__ feats, float* __restrict__ out,
               float* __restrict__ fields, int n) {
  CardWarp w;
  const long long b = blockIdx.x;
  mxu_warp<V>(table, feats, out + b * kTileLanes,
              fields == nullptr ? nullptr
                                : fields + b * Mxu<V>::kOut * kTileLanes,
              n, threadIdx.x >> 5, w);
}

template <int V>
cudaError_t launch_mxu(const void* table, const void* feats, float* out,
                       float* fields, int n, int tiles, cudaStream_t s) {
  mxu_kernel<V><<<tiles, kTileThreads, 0, s>>>(table, feats, out, fields,
                                              n);
  return cudaGetLastError();
}

using MxuLaunch = cudaError_t (*)(const void*, const void*, float*, float*,
                                  int, int, cudaStream_t);

template <int... Vs>
MxuLaunch mxu_launch(int v, std::integer_sequence<int, Vs...>) {
  MxuLaunch table[] = {launch_mxu<Vs>...};
  return table[v];
}

template <int... Vs>
const void* mxu_function(int v, std::integer_sequence<int, Vs...>) {
  const void* table[] = {reinterpret_cast<const void*>(mxu_kernel<Vs>)...};
  return table[v];
}

using AllMxu = std::make_integer_sequence<int, kMxuVariants>;

int info(const void* kernel, int threads, int smem, int* regs, int* local,
         int* blk, int* blocks) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = at.numRegs;
  *local = static_cast<int>(at.localSizeBytes);
  *blk = threads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem));
}

int chain_grid(int chains) {
  return (chains + kChainBlock - 1) / kChainBlock;
}
int chain_block(int chains) {
  return chains < kChainBlock ? chains : kChainBlock;
}

}  // namespace

// The copy of ``tiles`` [2048] f32 tiles x -> y (16-byte aligned) on
// ``stream``, one block a tile; with ``pdl`` a programmatic dependent of
// the kernel before it (cudaLaunchAttributeProgrammaticStreamSerialization,
// as csrc/key_sort.cu's passes launch).  Returns the launch's CUDA error
// code (0 when queued).
extern "C" int rtjax_probe_copy(const float* x, float* y, int tiles,
                                int pdl, void* stream) {
  if (tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float4* in = reinterpret_cast<const float4*>(x);
  float4* out = reinterpret_cast<float4*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pdl) {
    copy_kernel<false><<<tiles, kCopyThreads, 0, s>>>(in, out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles);
  config.blockDim = dim3(kCopyThreads);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, copy_kernel<true>, in,
                                           out);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Each of ``tiles`` [2048] f32 tiles of x summed into out[tile].
extern "C" int rtjax_probe_sum(const float* x, float* out, int tiles,
                               void* stream) {
  if (tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sum_kernel<<<tiles, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out);
  return static_cast<int>(cudaGetLastError());
}

// ``chains`` scalar walks of n steps over meta ([1024] int32), chain c's
// checksum into out[c].
extern "C" int rtjax_probe_scalar_walk(const int* meta, unsigned* out,
                                       int n, int chains, void* stream) {
  if (chains <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int block = chain_block(chains);
  scalar_walk_kernel<<<chain_grid(chains), block,
                       kStack * block * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(meta, out, n,
                                                            chains);
  return static_cast<int>(cudaGetLastError());
}

// ``chains`` clz loops of n iterations, chain c's checksum into out[c].
extern "C" int rtjax_probe_clz(unsigned* out, int n, int chains,
                               void* stream) {
  if (chains <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  clz_kernel<<<chain_grid(chains), chain_block(chains), 0,
               static_cast<cudaStream_t>(stream)>>>(out, n, chains);
  return static_cast<int>(cudaGetLastError());
}

// Tile probe ``variant`` (probes.cuh Variant) over table ([1024, 128] f32,
// 16-byte aligned) and rays ([7 or 6, 2048] f32): ``tiles`` blocks of n
// iterations, tile b's checksum into out[b].
extern "C" int rtjax_probe_tile(int variant, const float* table,
                                const float* rays, unsigned* out, int n,
                                int tiles, void* stream) {
  if (variant < 0 || variant >= kVariants || tiles <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tile_launch(variant, AllVariants{})(
      table, rays, out, n, tiles, static_cast<cudaStream_t>(stream)));
}

// Tensor-core probe ``variant`` (mxu_probes.cuh MxuVariant) over table (a
// probe's A blocks, 16-byte aligned) and feats (F, [K, 2048]): ``tiles``
// blocks of n iterations, tile b's best t into out[b] ([2048] f32) and,
// unless ``fields`` is null, its fields into fields[b].
extern "C" int rtjax_probe_mxu(int variant, const void* table,
                               const void* feats, float* out, float* fields,
                               int n, int tiles, void* stream) {
  if (variant < 0 || variant >= kMxuVariants || tiles <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mxu_launch(variant, AllMxu{})(
      table, feats, out, fields, n, tiles,
      static_cast<cudaStream_t>(stream)));
}

// A kernel's registers, local bytes a thread, threads a block and resident
// blocks an SM (kernels/probes.py KERNEL_IDS: 0 the copy, 1 the copy as a
// programmatic dependent, 2 the sum, 3 the scalar walk, 4 clz, 16 + v
// tile probe v, 32 + v tensor-core probe v).
extern "C" int rtjax_probe_kernel_info(int which, int* regs, int* local,
                                       int* block, int* blocks) {
  switch (which) {
    case 0:
      return info(reinterpret_cast<const void*>(copy_kernel<false>),
                  kCopyThreads, 0, regs, local, block, blocks);
    case 1:
      return info(reinterpret_cast<const void*>(copy_kernel<true>),
                  kCopyThreads, 0, regs, local, block, blocks);
    case 2:
      return info(reinterpret_cast<const void*>(sum_kernel), kCopyThreads,
                  0, regs, local, block, blocks);
    case 3:
      return info(reinterpret_cast<const void*>(scalar_walk_kernel),
                  kChainBlock, kStack * kChainBlock * sizeof(int), regs,
                  local, block, blocks);
    case 4:
      return info(reinterpret_cast<const void*>(clz_kernel), kChainBlock, 0,
                  regs, local, block, blocks);
    default:
      if (which >= 32 && which < 32 + kMxuVariants)
        return info(mxu_function(which - 32, AllMxu{}), kTileThreads, 0,
                    regs, local, block, blocks);
      if (which < 16 || which >= 16 + kVariants)
        return static_cast<int>(cudaErrorInvalidValue);
      return info(tile_function(which - 16, AllVariants{}), kTileThreads, 0,
                  regs, local, block, blocks);
  }
}
