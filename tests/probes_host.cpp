// The TPU probes' card kernels (rtjax_torch/csrc/probes.cu) on the host,
// over the loop bodies of rtjax_torch/csrc/probes.cuh compiled as C++
// (tests/test_torch_probes.py builds it with g++ and binds it with
// kernels/probes.py ``bind``, so that the real ctypes wrapper runs it on
// CPU tensors).  It exports the library's entry points and runs what the
// kernels run, serially: every tile's 256 threads, each its 8 lanes'
// loop, their checksums summed as the block sums them; every chain on its
// own 64-entry stack.  The card's broadcasts (UniformRow, ShflRow) both
// stand in as plain reads of the row: a lane of ShflRow's warp holds the
// same value the load would give it.  The copy and the sum run as
// memcpy and a sum in the kernel's order (a thread's 8 values, then the
// threads in order: the tests' data sum exactly in any order).
#include <cstring>

#include "probes.cuh"
using namespace rtjax_probes;

namespace {

constexpr int kNotOnCard = 1;   // kernel info: no card here
constexpr int kBadArgs = 2;

struct HostRow {
  const float* row;
  explicit HostRow(const float* r) : row(r) {}
  float4 load4(int q) const {
    return float4{row[4 * q], row[4 * q + 1], row[4 * q + 2],
                  row[4 * q + 3]};
  }
};

struct HostStack {
  int v[kStack];
  int get(int k) const { return v[k]; }
  void set(int k, int x) { v[k] = x; }
};

template <int V>
unsigned tile(const float* table, const float* rays, int n) {
  unsigned s = 0;
  for (int t = 0; t < kTileThreads; ++t)
    s += tile_thread<typename Probe<V>::Body, HostRow>(table, rays, t, n);
  return s;
}

using Tile = unsigned (*)(const float*, const float*, int);
const Tile kTiles[kVariants] = {
    tile<kSlabPair>,       tile<kSlabWide4>,        tile<kSlabWide8>,
    tile<kSlabWide8Row1>,  tile<kSlabWide8Fused>,   tile<kSlabWide16Fused>,
    tile<kLeafMt>,         tile<kLeafMtNodiv>,      tile<kLeafMtRow1>,
    tile<kLeafMtPar>};

}  // namespace

extern "C" int rtjax_probe_copy(const float* x, float* y, int tiles,
                                int pdl, void* stream) {
  (void)pdl;
  (void)stream;
  if (tiles <= 0) return kBadArgs;
  std::memcpy(y, x, sizeof(float) * kTileLanes * tiles);
  return 0;
}

extern "C" int rtjax_probe_sum(const float* x, float* out, int tiles,
                               void* stream) {
  (void)stream;
  if (tiles <= 0) return kBadArgs;
  for (int b = 0; b < tiles; ++b) {
    const float* tile = x + static_cast<long long>(b) * kTileLanes;
    float s = 0.0f;
    for (int t = 0; t < kTileThreads; ++t) {
      float p = 0.0f;
      for (int k = 0; k < kTileLanes / kTileThreads; ++k)
        p += tile[k * kTileThreads + t];
      s += p;
    }
    out[b] = s;
  }
  return 0;
}

extern "C" int rtjax_probe_scalar_walk(const int* meta, unsigned* out,
                                       int n, int chains, void* stream) {
  (void)stream;
  if (chains <= 0 || n < 0) return kBadArgs;
  for (int c = 0; c < chains; ++c) {
    HostStack s;
    out[c] = scalar_walk(meta, s, n);
  }
  return 0;
}

extern "C" int rtjax_probe_clz(unsigned* out, int n, int chains,
                               void* stream) {
  (void)stream;
  if (chains <= 0 || n < 0) return kBadArgs;
  for (int c = 0; c < chains; ++c) out[c] = clz_chain(n);
  return 0;
}

extern "C" int rtjax_probe_tile(int variant, const float* table,
                                const float* rays, unsigned* out, int n,
                                int tiles, void* stream) {
  (void)stream;
  if (variant < 0 || variant >= kVariants || tiles <= 0 || n < 0)
    return kBadArgs;
  for (int b = 0; b < tiles; ++b) out[b] = kTiles[variant](table, rays, n);
  return 0;
}

extern "C" int rtjax_probe_kernel_info(int which, int* regs, int* local,
                                       int* block, int* blocks) {
  (void)which;
  *regs = *local = *block = *blocks = 0;
  return kNotOnCard;
}
