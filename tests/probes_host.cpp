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
//
// The tensor-core probes (csrc/mxu_probes.cuh mxu_warp) run warp by warp:
// a warp's 32 lanes are fibers on one thread, each running the card's
// lane code until its next warp-wide operation (a shuffle, an mma.sync);
// when all 32 wait at the same operation, the shim computes it for the
// warp, as the card does, and resumes them.  A shuffle reads its source
// lane's value; the mma gathers A, B and C from the 32 lanes' registers by
// the PTX ISA's fragment layouts (mma.m16n8k16 .bf16, mma.m16n8k8 .tf32;
// TF32 operands lose their low 13 bits, as the instruction ignores them),
// adds the products to C in k order (each product exact in f32) and
// scatters D back.  Lanes that leave or wait at different operations are
// a divergence, which the entry point reports.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#include "mxu_probes.cuh"
#include "probes.cuh"
using namespace rtjax_probes;

// Switch stacks: save the callee-saved registers and the stack pointer
// into *save, load them from ``load`` (x86-64 System V).
extern "C" void fiber_switch(void** save, void* load);
asm(R"(
  .text
  .p2align 4
  .globl fiber_switch
  .hidden fiber_switch
  .type fiber_switch, @function
fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size fiber_switch, .-fiber_switch
)");

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

// --------------------------------------------------- a warp of fibers
enum class Op { kShflF, kShflI, kMmaBf16, kMmaTf32, kDone };

struct Post {    // what a lane brings to a warp operation, and gets back
  Op op;
  int src;       // a shuffle's source lane
  float f;
  int i;
  uint32_t a[4], b[2];
  float c[4];
};

constexpr std::size_t kFiberStack = 1 << 18;

struct WarpRun {
  void* main_sp = nullptr;
  void* sp[32];
  Post post[32];
  Post res[32];
  int current = 0;
  std::function<void(int)> body;
};

WarpRun* g_run = nullptr;

void fiber_entry() {
  WarpRun& r = *g_run;
  const int lane = r.current;
  r.body(lane);
  r.post[lane].op = Op::kDone;
  fiber_switch(&r.sp[lane], r.main_sp);
  std::abort();   // a finished lane is never resumed
}

// the card's warp (csrc/probes.cu CardWarp) for one fiber
struct HostWarp {
  int id;
  int lane() const { return id; }
  const Post& wait(const Post& p) const {
    g_run->post[id] = p;
    fiber_switch(&g_run->sp[id], g_run->main_sp);
    return g_run->res[id];
  }
  float shfl_xor(float v, int m) const { return shfl(v, id ^ m); }
  int shfl_xor(int v, int m) const {
    Post p{};
    p.op = Op::kShflI;
    p.src = id ^ m;
    p.i = v;
    return wait(p).i;
  }
  float shfl(float v, int src) const {
    Post p{};
    p.op = Op::kShflF;
    p.src = src;
    p.f = v;
    return wait(p).f;
  }
  void mma(Op op, float (&d)[4], const uint32_t (&a)[4],
           const uint32_t (&b)[2]) const {
    Post p{};
    p.op = op;
    std::memcpy(p.a, a, sizeof p.a);
    std::memcpy(p.b, b, sizeof p.b);
    std::memcpy(p.c, d, sizeof p.c);
    std::memcpy(d, wait(p).c, sizeof p.c);
  }
  void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                const uint32_t (&b)[2]) const {
    mma(Op::kMmaBf16, d, a, b);
  }
  void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                const uint32_t (&b)[2]) const {
    mma(Op::kMmaTf32, d, a, b);
  }
};

float bf16_at(uint32_t reg, int half) {
  return bits_f32((half ? reg >> 16 : reg & 0xffffu) << 16);
}

// D = C + A · B for the warp, the fragments by the PTX ISA's figures
// (groupID = lane >> 2, threadID_in_group = lane % 4)
void warp_mma(WarpRun& r, bool bf16) {
  const int K = bf16 ? 16 : 8;
  float A[16][16], B[16][8], C[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, q = l & 3;
    const Post& p = r.post[l];
    if (bf16) {
      for (int i = 0; i < 8; ++i) {   // a0..a7, two a register
        const int row = (i < 2 || (i >= 4 && i < 6)) ? g : g + 8;
        const int col = q * 2 + (i & 1) + (i >= 4 ? 8 : 0);
        A[row][col] = bf16_at(p.a[i >> 1], i & 1);
      }
      for (int i = 0; i < 4; ++i) {   // b0..b3
        const int row = q * 2 + (i & 1) + (i >= 2 ? 8 : 0);
        B[row][g] = bf16_at(p.b[i >> 1], i & 1);
      }
    } else {
      for (int i = 0; i < 4; ++i) {   // a0..a3, one a register
        const int row = (i == 0 || i == 2) ? g : g + 8;
        const int col = q + (i >= 2 ? 4 : 0);
        A[row][col] = bits_f32(p.a[i] & 0xffffe000u);
      }
      for (int i = 0; i < 2; ++i)     // b0, b1
        B[q + (i == 1 ? 4 : 0)][g] = bits_f32(p.b[i] & 0xffffe000u);
    }
    for (int i = 0; i < 4; ++i)       // c0..c3
      C[g + (i >= 2 ? 8 : 0)][q * 2 + (i & 1)] = p.c[i];
  }
  for (int row = 0; row < 16; ++row)
    for (int col = 0; col < 8; ++col)
      for (int k = 0; k < K; ++k) C[row][col] += A[row][k] * B[k][col];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, q = l & 3;
    for (int i = 0; i < 4; ++i)
      r.res[l].c[i] = C[g + (i >= 2 ? 8 : 0)][q * 2 + (i & 1)];
  }
}

// Runs ``body(lane)`` for the 32 lanes of a warp in step; false when the
// lanes diverge at a warp operation.
bool run_warp(std::function<void(int)> body) {
  WarpRun r;
  r.body = std::move(body);
  std::vector<char> stacks(32 * kFiberStack);
  for (int l = 0; l < 32; ++l) {
    const std::uintptr_t top = reinterpret_cast<std::uintptr_t>(
        stacks.data() + (l + 1) * kFiberStack) & ~std::uintptr_t{15};
    // six callee-saved registers, then fiber_entry as the return address
    void** sp = reinterpret_cast<void**>(top - 64);
    for (int k = 0; k < 8; ++k) sp[k] = nullptr;
    sp[6] = reinterpret_cast<void*>(&fiber_entry);
    r.sp[l] = sp;
    r.post[l].op = Op::kShflF;
  }
  WarpRun* outer = g_run;
  g_run = &r;
  bool ok = true;
  for (bool started = false;; started = true) {
    for (int l = 0; l < 32; ++l) {
      if (started && r.post[l].op == Op::kDone) continue;
      r.current = l;
      fiber_switch(&r.main_sp, r.sp[l]);
    }
    const Op op = r.post[0].op;
    for (int l = 1; l < 32; ++l) ok = ok && r.post[l].op == op;
    if (!ok || op == Op::kDone) break;
    if (op == Op::kMmaBf16 || op == Op::kMmaTf32) {
      warp_mma(r, op == Op::kMmaBf16);
      continue;
    }
    for (int l = 0; l < 32; ++l) {
      const int src = r.post[l].src;
      if (src < 0 || src >= 32) ok = false;
      r.res[l].f = r.post[src & 31].f;
      r.res[l].i = r.post[src & 31].i;
    }
    if (!ok) break;
  }
  g_run = outer;
  return ok;
}

template <int V>
bool mxu_tile(const void* table, const void* feats, float* out,
              float* fields, int n) {
  for (int warp = 0; warp < kMxuWarps; ++warp) {
    const bool ok = run_warp([=](int lane) {
      HostWarp w{lane};
      mxu_warp<V>(table, feats, out, fields, n, warp, w);
    });
    if (!ok) return false;
  }
  return true;
}

using MxuTile = bool (*)(const void*, const void*, float*, float*, int);
const MxuTile kMxuTiles[kMxuVariants] = {
    mxu_tile<kMxuF32>,      mxu_tile<kMxuBf16>,     mxu_tile<kMxuFull>,
    mxu_tile<kMxuFullHi>,   mxu_tile<kMxuPair>,     mxu_tile<kMxuPairHi>,
    mxu_tile<kMxuG8Splitk>, mxu_tile<kMxuG4Splitk>, mxu_tile<kMxuG2Splitk>,
    mxu_tile<kMxuG8F32>};

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

constexpr int kDiverged = 3;   // a warp's lanes met different operations

extern "C" int rtjax_probe_mxu(int variant, const void* table,
                               const void* feats, float* out, float* fields,
                               int n, int tiles, void* stream) {
  (void)stream;
  if (variant < 0 || variant >= kMxuVariants || tiles <= 0 || n < 0)
    return kBadArgs;
  static const int kOut[kMxuVariants] = {
      Mxu<kMxuF32>::kOut,      Mxu<kMxuBf16>::kOut,
      Mxu<kMxuFull>::kOut,     Mxu<kMxuFullHi>::kOut,
      Mxu<kMxuPair>::kOut,     Mxu<kMxuPairHi>::kOut,
      Mxu<kMxuG8Splitk>::kOut, Mxu<kMxuG4Splitk>::kOut,
      Mxu<kMxuG2Splitk>::kOut, Mxu<kMxuG8F32>::kOut};
  for (int b = 0; b < tiles; ++b) {
    float* f = fields == nullptr
                   ? nullptr
                   : fields + static_cast<long long>(b) * kOut[variant] *
                                  kTileLanes;
    if (!kMxuTiles[variant](table, feats,
                            out + static_cast<long long>(b) * kTileLanes, f,
                            n))
      return kDiverged;
  }
  return 0;
}

extern "C" int rtjax_probe_kernel_info(int which, int* regs, int* local,
                                       int* block, int* blocks) {
  (void)which;
  *regs = *local = *block = *blocks = 0;
  return kNotOnCard;
}
