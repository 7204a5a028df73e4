// The stable key sort for Hopper (sm_90a): an LSD radix sort of int32
// keys that returns the stable permutation, bit for bit
// torch.sort(keys, stable=True).indices (a stable sort's permutation is
// unique).  kernels/sort.py binds it; the arithmetic is key_sort.cuh's.
//
// Replaces: rtjax/render/sorting.py:126 sort_pytree_by_key, the one
// lax.sort(..., num_keys=1, is_stable=True) at :152, which rtjax calls at
// rtjax/render/wavefront.py:361 (reference_parity), :396-401 (the compact
// bundle, under lax.cond(do_gen, ...) when k_sort > 1) and :424 (the wide
// bundle).  No pallas_call: XLA's sort.  The port's step (render/
// wavefront.py _fused_step) calls it between route and shade on every
// sorted path; the op-by-op step keeps torch.sort, its plain version.
//
// What bounds it on this card: not the bytes.  A sort of 2^18 keys must
// read 1 MiB of keys and write 2 MiB of order, 0.94 us at 3.35 TB/s, and
// every pass's keys and indices stay in the 50 MB L2.  At 2^17-2^20 keys a
// pass's blocks all run at once, so a kernel takes as long as one block's
// chain of dependent steps: the ticket's atomic, the loads, the ranking,
// the look-back's L2 round trips, the barriers; and the kernel boundaries
// between passes (PERF.md gives the parts' times).
//
// What the design does about that:
// - no memset node: the scratch is persistent (kernels/sort.py makes one
//   a card and size, zeroed once) and nothing in it is zeroed before a
//   launch.  Every kernel takes its tickets from counters that atomicInc
//   runs over two launches' worth (key_sort.cuh ticket_limit), so a ticket
//   gives the launch's parity; the status words carry the parity's tag,
//   so a word of the launch before reads as not published; the upsweep
//   adds to the histogram plane of its parity and zeroes the other plane
//   for the next launch;
// - one upsweep kernel that reads the keys once and counts every pass's
//   digits (all of a thread's loads in flight at once; a histogram a warp
//   in shared memory, a run of equal digits added once, so equal keys
//   contend little; one global atomic a bin a block); then one kernel a
//   pass (onesweep), which launches as a programmatic dependent of the
//   kernel before it, so that its launch and its ticket overlap that
//   kernel's tail, and the first pass ranks and looks back while the
//   upsweep still counts;
// - a pass kernel's block takes its tile from an atomic ticket, so it
//   waits only on tiles whose blocks already run; ranks its keys stably
//   in the warp that holds them (peers by one ballot a digit bit, a
//   counter a digit a warp in shared memory, the warps' counters scanned
//   in order), publishes its digit counts, takes each digit's offset by a
//   decoupled look-back over the earlier tiles' status words (a thread a
//   digit, kLook tiles' words in flight at once), the digit's offset over
//   the pass by a scan of the upsweep's histogram beside the tile's own
//   scan, stages its keys in shared memory in sorted order and writes
//   them out in runs of equal digits;
// - indices ride as int32 beside their keys, one 8-byte pair a key
//   between passes (one load and one store a key); the first pass makes
//   them from the position and the last writes int64 straight into the
//   order shade reads;
// - equal keys (the dead lanes' 0x7FFFFFFE / 0x7FFFFFFF late in a frame)
//   make one peer group: one counter update a warp an item, no serialised
//   shared-memory atomics;
// - with a cadence (the default engine's sort_every): inside a captured
//   step the kernels sit in the body of a CUDA-graph if node whose
//   condition cadence_condition sets (render/device_loop.py), so that an
//   iteration that does not sort runs one one-thread kernel; launched
//   outside a capture, every block of every kernel returns at once on
//   such an iteration.  Either way the order is left as it is: shade
//   reads the identity then (step_math.cuh shade_lane).
// Built and timed too, and slower (PERF.md section 6): digits of 11 / 11
// / 10 bits in three passes (1.7-1.9x); thread-block clusters of 2-8
// tiles that add their counts in distributed shared memory and look back
// as one; the upsweep with one histogram a block added to once a warp
// for each group of equal digits (__match_any_sync), at 8 or 16 keys a
// thread; a later pass's tile loaded by one bulk copy (TMA).  The first
// design (a memset node a launch, the cadence in its kernels) stays as
// rtjax_key_sort_v1 for timing in turns (tools/sort_designs.py).
#include <cuda_runtime.h>

#include "key_sort.cuh"

namespace {

using namespace rtjax_sort;

struct SortArgs {
  const int* keys;
  long long* order;
  unsigned char* scratch;
  int n;
  const long long* counts;  // null: no cadence
  const long long* it;      // null: it_value
  long long it_value;
  int sort_every;
  unsigned long long* tally;  // null, or [full sorts, returned at once]
};

__device__ __forceinline__ bool sorts(const SortArgs& a) {
  return cadence(a.counts, a.it, a.it_value, a.sort_every, a.n);
}

// Programmatic dependent launch (RTJAX_SORT_PDL): a kernel lets the next
// one's blocks be scheduled as soon as all of its own run, and a pass
// waits for the kernel before it to finish, its writes visible, only
// where it reads them; so a pass's launch and its ticket overlap the
// previous kernel's tail, and the first pass ranks and looks back while
// the upsweep counts
__device__ __forceinline__ void launch_dependents() {
#if RTJAX_SORT_PDL
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}
__device__ __forceinline__ void wait_for_previous() {
#if RTJAX_SORT_PDL
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// the lanes of the warp whose digit equals this lane's (a ballot a bit);
// ``valid`` false leaves a lane out of every group (``full``: every lane
// valid, one ballot fewer)
__device__ __forceinline__ unsigned peers_of(unsigned d, bool valid,
                                             bool full) {
  unsigned m = full ? 0xFFFFFFFFu : __ballot_sync(0xFFFFFFFFu, valid);
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned v = __ballot_sync(0xFFFFFFFFu, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// the exclusive prefix sums over the block of two values a thread (x and
// y apart); ``warp_total`` kWarps pairs of shared memory
__device__ __forceinline__ uint2 block_exclusive(uint2 v,
                                                 uint2* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint2 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned tx = __shfl_up_sync(0xFFFFFFFFu, inc.x, o);
    const unsigned ty = __shfl_up_sync(0xFFFFFFFFu, inc.y, o);
    if (lane >= o) {
      inc.x += tx;
      inc.y += ty;
    }
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  uint2 run = make_uint2(inc.x - v.x, inc.y - v.y);
  for (int w = 0; w < warp; ++w) {
    run.x += warp_total[w].x;
    run.y += warp_total[w].y;
  }
  return run;
}

__device__ __forceinline__ unsigned status_load(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

constexpr int kCounterBytes = kWarps * kRadix * 2, kStagedBytes = kTile * 8;
constexpr int kRegion =
    kCounterBytes > kStagedBytes ? kCounterBytes : kStagedBytes;

// every pass's digit counts, added to the histogram plane of the launch's
// parity; the first block zeroes the other plane for the next launch
__global__ void __launch_bounds__(kBlock) sort_upsweep(const SortArgs a) {
  const bool full = sorts(a);
  if (a.tally != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.tally + (full ? 0 : 1), 1ULL);
  if (!full) return;
  launch_dependents();
  const Layout l = layout(a.n);
  const int blocks = upsweep_blocks(a.n);
  unsigned* counters = reinterpret_cast<unsigned*>(a.scratch + l.counters);
  __shared__ unsigned ticket_s;
  __shared__ unsigned hist[kWarps][kPasses * kRadix];
  if (threadIdx.x == 0)
    ticket_s = atomicInc(counters + kUpTicket, ticket_limit(blocks));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* h = hist[warp];
  for (int i = lane; i < kPasses * kRadix; i += 32) h[i] = 0;
  // the thread's keys, every load in flight at once; its valid keys are a
  // prefix of its items
  const long long first = static_cast<long long>(blockIdx.x) * kBlock *
                          kUpItems;
  unsigned u[kUpItems];
  int valid = 0;
#pragma unroll
  for (int k = 0; k < kUpItems; ++k) {
    const long long i = first + k * kBlock + threadIdx.x;
    u[k] = i < a.n ? flip(__ldg(a.keys + i)) : 0u;
    valid += i < a.n;
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    // a run of equal digits adds once
    unsigned cur = digit(u[0], p), run = 0;
#pragma unroll
    for (int k = 0; k < kUpItems; ++k) {
      if (k < valid) {
        const unsigned d = digit(u[k], p);
        if (d != cur) {
          atomicAdd(&h[p * kRadix + cur], run);
          cur = d;
          run = 0;
        }
        ++run;
      }
    }
    if (run != 0) atomicAdd(&h[p * kRadix + cur], run);
  }
  __syncthreads();
  const unsigned parity = launch_parity(ticket_s, blocks);
  unsigned* g = reinterpret_cast<unsigned*>(a.scratch + l.hist);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < kPasses * kRadix; i += kBlock)
      g[(parity ^ 1u) * plane_words() + i] = 0;
  g += parity * plane_words();
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kBlock) {
    unsigned s = 0;
    for (int w = 0; w < kWarps; ++w) s += hist[w][i];
    if (s != 0) atomicAdd(g + i, s);
  }
}

// one pass of the sort: its digit's stable scatter of one tile
__global__ void __launch_bounds__(kBlock) sort_pass(const SortArgs a,
                                                    const int pass) {
  if (!sorts(a)) return;
  launch_dependents();
  // the warps' digit counters, then the tile's staged keys and indices;
  // each digit's start in the tile and its scatter base
  __shared__ __align__(16) unsigned char region[kRegion];
  __shared__ int tstart[kRadix], base[kRadix];
  __shared__ unsigned ticket_s;
  __shared__ uint2 warp_total[kWarps];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(region);
  uint2* staged = reinterpret_cast<uint2*>(region);

  const Layout l = layout(a.n);
  const int tiles = num_tiles(a.n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int own = threadIdx.x;   // the digit this thread looks back for
  if (threadIdx.x == 0)
    ticket_s = atomicInc(reinterpret_cast<unsigned*>(a.scratch +
                                                     l.counters) + 1 + pass,
                         ticket_limit(tiles));
  unsigned short* mine = cnt + warp * kRadix;
  for (int d = lane; d < kRadix; d += 32) mine[d] = 0;
  // the ticket taken while the kernel before still runs; the first pass
  // reads the caller's keys and ranks its tile while the upsweep still
  // counts, and waits for the histogram only after its look-back
  __syncthreads();
  const unsigned ticket = ticket_s;
  if (pass > 0) wait_for_previous();
  const unsigned parity = launch_parity(ticket, tiles);
  const int tile = ticket_index(ticket, tiles);
  const long long first = static_cast<long long>(tile) * kTile;
  const bool last = pass == kPasses - 1;
  // the digit's count over the pass (the upsweep's)
  const unsigned* hist = reinterpret_cast<const unsigned*>(
      a.scratch + l.hist) + parity * plane_words() + pass * kRadix;
  unsigned total = pass > 0 ? hist[own] : 0u;
  const uint2* in = reinterpret_cast<const uint2*>(
      a.scratch + ((pass & 1) ? l.pairs0 : l.pairs1));

  // the tile's keys, each warp's run of kItems * 32 in order
  unsigned key[kItems];
  int idx[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + item_offset(warp, k, lane);
    key[k] = 0u;
    idx[k] = 0;
    if (i < a.n) {
      if (pass == 0) {
        key[k] = flip(__ldg(a.keys + i));
        idx[k] = static_cast<int>(i);
      } else {
        const uint2 v = in[i];
        key[k] = v.x;
        idx[k] = static_cast<int>(v.y);
      }
    }
  }
  // ranks within the warp: the warp's count of the digit before the item,
  // and the lower lanes of the same digit in it (every item's peers
  // first, so that only the counters chain the items)
  unsigned peers[kItems];
  const bool full = first + kTile <= a.n;   // a whole tile of keys
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    peers[k] = peers_of(digit(key[k], pass),
                        first + item_offset(warp, k, lane) < a.n, full);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = first + item_offset(warp, k, lane) < a.n;
    const unsigned d = digit(key[k], pass);
    const int before = valid ? mine[d] : 0;
    __syncwarp();
    if (valid && lane == leader(peers[k]))
      mine[d] = static_cast<unsigned short>(before + popc(peers[k]));
    __syncwarp();
    rank[k] = warp_rank(before, peers[k], lane);
  }
  __syncthreads();

  // this thread's digit: the warps' counts made exclusive, the tile's
  // count published for the later tiles
  unsigned count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = cnt[w * kRadix + own];
    cnt[w * kRadix + own] = static_cast<unsigned short>(count);
    count += c;
  }
  unsigned* status = reinterpret_cast<unsigned*>(a.scratch + l.status) +
                     static_cast<long long>(pass) * tiles * kRadix;
  unsigned* word = status + static_cast<long long>(tile) * kRadix + own;
  atomicExch(word, status_word(parity, tile == 0, count));
  // the decoupled look-back: the digit's count over the earlier tiles,
  // kLook status words in flight at a time (tile 0's always a prefix)
  unsigned before = 0;
  if (tile > 0) {
    for (int j = tile - 1;;) {
      unsigned w[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q)
        w[q] = j - q >= 0 ? status_load(status + static_cast<long long>(
                                                     j - q) * kRadix + own)
                          : status_word(parity, true, 0);
      const int back = lookback_step(w, parity, before);
      if (back < 0) break;
      j -= back;
    }
    atomicExch(word, status_word(parity, true, before + count));
  }
  if (pass == 0) {
    wait_for_previous();
    total = hist[own];
  }
  // the digit's start in the tile and over the pass
  const uint2 start = block_exclusive(make_uint2(count, total), warp_total);
  tstart[own] = static_cast<int>(start.x);
  base[own] = static_cast<int>(start.y + before) -
              static_cast<int>(start.x);
  __syncthreads();

  // the keys staged in the tile's sorted order
  int at[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned d = digit(key[k], pass);
    at[k] = tstart[d] + cnt[warp * kRadix + d] + rank[k];
  }
  __syncthreads();   // the counters are read: the staging takes their place
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (first + item_offset(warp, k, lane) < a.n) {
      staged[at[k]] = make_uint2(key[k], static_cast<unsigned>(idx[k]));
    }
  }
  __syncthreads();
  // written out in runs of equal digits
  const long long left = a.n - first;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  uint2* out = reinterpret_cast<uint2*>(
      a.scratch + ((pass & 1) ? l.pairs1 : l.pairs0));
  for (int j = threadIdx.x; j < tile_n; j += kBlock) {
    const uint2 v = staged[j];
    const long long dst = base[digit(v.x, pass)] + j;
    if (last)
      a.order[dst] = static_cast<int>(v.y);
    else
      out[dst] = v;
  }
}

// The condition of the if node that holds a captured step's sort (one
// thread): the cadence, counted in the tally
__global__ void cadence_condition(cudaGraphConditionalHandle handle,
                                  const long long* counts,
                                  const long long* it, long long it_value,
                                  int sort_every, int n,
                                  unsigned long long* tally) {
  const bool full = cadence(counts, it, it_value, sort_every, n);
  if (tally != nullptr) atomicAdd(tally + (full ? 0 : 1), 1ULL);
  cudaGraphSetConditional(handle, full ? 1u : 0u);
}

}  // namespace

// the first design, kept for timing in turns (rtjax_key_sort_v1): a memset
// node zeroes the fresh scratch's counters, the upsweep counts with a
// histogram a warp, every tile looks back on its own (key_sort.cuh's v1
// arithmetic)
namespace rtjax_sort {
namespace v1 {

constexpr int kRegion = kTile * 8;   // > the counters' kWarps x kRadix x 2

__global__ void __launch_bounds__(kBlock) upsweep_kernel(const SortArgs a) {
  const bool full = sorts(a);
  if (a.tally != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.tally + (full ? 0 : 1), 1ULL);
  if (!full) return;
  launch_dependents();
  __shared__ unsigned hist[kWarps][kPasses * kRadix];
  const Layout l = layout(a.n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* h = hist[warp];
  for (int i = lane; i < kPasses * kRadix; i += 32) h[i] = 0;
  const long long first = static_cast<long long>(blockIdx.x) * kBlock *
                          kUpItems;
  unsigned u[kUpItems];
  int valid = 0;
#pragma unroll
  for (int k = 0; k < kUpItems; ++k) {
    const long long i = first + k * kBlock + threadIdx.x;
    u[k] = i < a.n ? flip(__ldg(a.keys + i)) : 0u;
    valid += i < a.n;
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    unsigned cur = digit(u[0], p), run = 0;
#pragma unroll
    for (int k = 0; k < kUpItems; ++k) {
      if (k < valid) {
        const unsigned d = digit(u[k], p);
        if (d != cur) {
          atomicAdd(&h[p * kRadix + cur], run);
          cur = d;
          run = 0;
        }
        ++run;
      }
    }
    if (run != 0) atomicAdd(&h[p * kRadix + cur], run);
  }
  __syncthreads();
  unsigned* g = reinterpret_cast<unsigned*>(a.scratch + l.hist);
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kBlock) {
    unsigned s = 0;
    for (int w = 0; w < kWarps; ++w) s += hist[w][i];
    if (s != 0) atomicAdd(g + i, s);
  }
}

__global__ void __launch_bounds__(kBlock) pass_kernel(const SortArgs a,
                                                      const int pass) {
  if (!sorts(a)) return;
  launch_dependents();
  __shared__ __align__(16) unsigned char region[kRegion];
  __shared__ int tstart[kRadix], base[kRadix];
  __shared__ int tile_s;
  __shared__ uint2 warp_total[kWarps];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(region);
  uint2* staged = reinterpret_cast<uint2*>(region);

  const Layout l = layout(a.n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int own = threadIdx.x;
  if (threadIdx.x == 0)
    tile_s = static_cast<int>(atomicAdd(
        reinterpret_cast<unsigned*>(a.scratch + l.tickets) + pass, 1u));
  unsigned short* mine = cnt + warp * kRadix;
  for (int d = lane; d < kRadix; d += 32) mine[d] = 0;
  const unsigned* hist = reinterpret_cast<const unsigned*>(
      a.scratch + l.hist) + pass * kRadix;
  unsigned total = 0;
  if (pass > 0) {
    wait_for_previous();
    total = hist[own];
  }
  __syncthreads();
  const int tile = tile_s;
  const long long first = static_cast<long long>(tile) * kTile;
  const bool last = pass == kPasses - 1;
  const uint2* in = reinterpret_cast<const uint2*>(
      a.scratch + ((pass & 1) ? l.pairs0 : l.pairs1));

  unsigned key[kItems];
  int idx[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = first + item_offset(warp, k, lane);
    key[k] = 0u;
    idx[k] = 0;
    if (i < a.n) {
      if (pass == 0) {
        key[k] = flip(__ldg(a.keys + i));
        idx[k] = static_cast<int>(i);
      } else {
        const uint2 v = in[i];
        key[k] = v.x;
        idx[k] = static_cast<int>(v.y);
      }
    }
  }
  unsigned peers[kItems];
  const bool full = first + kTile <= a.n;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    peers[k] = peers_of(digit(key[k], pass),
                        first + item_offset(warp, k, lane) < a.n, full);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = first + item_offset(warp, k, lane) < a.n;
    const unsigned d = digit(key[k], pass);
    const int before = valid ? mine[d] : 0;
    __syncwarp();
    if (valid && lane == leader(peers[k]))
      mine[d] = static_cast<unsigned short>(before + popc(peers[k]));
    __syncwarp();
    rank[k] = warp_rank(before, peers[k], lane);
  }
  __syncthreads();

  unsigned* status = reinterpret_cast<unsigned*>(a.scratch + l.status) +
                     static_cast<long long>(pass) * num_tiles(a.n) * kRadix;
  unsigned count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = cnt[w * kRadix + own];
    cnt[w * kRadix + own] = static_cast<unsigned short>(count);
    count += c;
  }
  atomicExch(status + static_cast<long long>(tile) * kRadix + own,
             status_word(tile == 0 ? kPrefix : kAggregate, count));
  unsigned before = 0;
  if (tile > 0) {
    for (int j = tile - 1;;) {
      unsigned w[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q)
        w[q] = j - q >= 0 ? status_load(status + static_cast<long long>(
                                                     j - q) * kRadix + own)
                          : kPrefix;
      const int back = lookback_step(w, before);
      if (back < 0) break;
      j -= back;
    }
    atomicExch(status + static_cast<long long>(tile) * kRadix + own,
               status_word(kPrefix, before + count));
  }
  if (pass == 0) {
    wait_for_previous();
    total = hist[own];
  }
  const uint2 start = block_exclusive(make_uint2(count, total), warp_total);
  tstart[own] = static_cast<int>(start.x);
  base[own] = static_cast<int>(start.y + before) -
              static_cast<int>(start.x);
  __syncthreads();

  int at[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned d = digit(key[k], pass);
    at[k] = tstart[d] + cnt[warp * kRadix + d] + rank[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (first + item_offset(warp, k, lane) < a.n) {
      staged[at[k]] = make_uint2(key[k], static_cast<unsigned>(idx[k]));
    }
  }
  __syncthreads();
  const long long left = a.n - first;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  uint2* out = reinterpret_cast<uint2*>(
      a.scratch + ((pass & 1) ? l.pairs1 : l.pairs0));
  for (int j = threadIdx.x; j < tile_n; j += kBlock) {
    const uint2 v = staged[j];
    const long long dst = base[digit(v.x, pass)] + j;
    if (last)
      a.order[dst] = static_cast<int>(v.y);
    else
      out[dst] = v;
  }
}

}  // namespace v1
}  // namespace rtjax_sort

namespace {

namespace first_design = rtjax_sort::v1;

template <typename Kernel>
int info(Kernel kernel, int threads, int* regs, int* local, int* blk,
         int* blocks) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = at.numRegs;
  *local = static_cast<int>(at.localSizeBytes);
  *blk = threads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, 0));
}

// the passes' launch: ``blocks`` blocks, programmatic dependents of the
// kernel before
template <typename Kernel>
cudaError_t launch_passes(Kernel kernel, const SortArgs& a, int blocks,
                          cudaStream_t s) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kBlock);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = RTJAX_SORT_PDL;
  config.attrs = attr;
  config.numAttrs = 1;
  for (int p = 0; p < kPasses; ++p) {
    const cudaError_t e = cudaLaunchKernelEx(&config, kernel, a, p);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Bytes of the persistent scratch a sort of n keys takes (zeroed once,
// before its first launch).
extern "C" long long rtjax_key_sort_scratch_bytes(int n) {
  return layout(n).total;
}

// The stable order of ``n`` int32 keys into ``order`` (int64) on
// ``stream``: the upsweep and one kernel a pass, on ``scratch``, the
// persistent scratch of this size (launches that share it run in stream
// order).  ``counts`` (null: none), ``it`` (null: ``it_value``) and
// ``sort_every``: the default engine's cadence (every kernel returns at
// once where it does not sort).  ``tally`` (null: none) counts the
// launches that sorted and those that returned at once.  Returns the
// launch's CUDA error code (0 when queued).
extern "C" int rtjax_key_sort(const int* keys, long long* order,
                              void* scratch, int n, const long long* counts,
                              const long long* it, long long it_value,
                              int sort_every, unsigned long long* tally,
                              void* stream) {
  if (n <= 0) return 0;
  if (n > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  const SortArgs a = {keys, order, static_cast<unsigned char*>(scratch), n,
                      counts, it, it_value, sort_every, tally};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sort_upsweep<<<upsweep_blocks(n), kBlock, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_passes(sort_pass, a, num_tiles(n), s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The condition kernel of the if node that holds a captured step's sort
// (render/device_loop.py): on ``stream``, under capture, sets ``handle``
// (a conditional handle of the captured graph) to the cadence of
// ``counts``, ``it`` / ``it_value`` and ``sort_every`` over ``n`` keys,
// and counts it in ``tally`` (null: none).  The body's launches then take
// no cadence.  Returns the launch's CUDA error code.
extern "C" int rtjax_key_sort_condition(unsigned long long handle,
                                        const long long* counts,
                                        const long long* it,
                                        long long it_value, int sort_every,
                                        int n, unsigned long long* tally,
                                        void* stream) {
  cadence_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, counts, it, it_value, sort_every, n, tally);
  return static_cast<int>(cudaGetLastError());
}

// the first design: bytes of its scratch (a fresh one a launch).
extern "C" long long rtjax_key_sort_v1_scratch_bytes(int n) {
  return first_design::layout(n).total;
}

// the first design, as rtjax_key_sort but on a fresh scratch whose
// counters its memset node zeroes first.
extern "C" int rtjax_key_sort_v1(const int* keys, long long* order,
                                 void* scratch, int n,
                                 const long long* counts,
                                 const long long* it, long long it_value,
                                 int sort_every, unsigned long long* tally,
                                 void* stream) {
  if (n <= 0) return 0;
  if (n > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  const SortArgs a = {keys, order, static_cast<unsigned char*>(scratch), n,
                      counts, it, it_value, sort_every, tally};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, first_design::layout(n).zeroed, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  first_design::upsweep_kernel<<<first_design::upsweep_blocks(n), kBlock,
                                 0, s>>>(a);
  const cudaError_t le = launch_passes(first_design::pass_kernel, a,
                                       first_design::num_tiles(n), s);
  return static_cast<int>(le != cudaSuccess ? le : cudaGetLastError());
}

// A kernel's registers, local bytes a thread, threads a block and resident
// blocks an SM (kernels/sort.py KERNEL_IDS: 0 the upsweep, 1 a pass, 2 the
// if node's condition, 3 and 4 the first design's upsweep and pass).
extern "C" int rtjax_key_sort_kernel_info(int which, int* regs, int* local,
                                          int* block, int* blocks) {
  switch (which) {
    case 0: return info(sort_upsweep, kBlock, regs, local, block, blocks);
    case 1: return info(sort_pass, kBlock, regs, local, block, blocks);
    case 2: return info(cadence_condition, 1, regs, local, block, blocks);
    case 3: return info(first_design::upsweep_kernel, kBlock, regs, local,
                        block, blocks);
    case 4: return info(first_design::pass_kernel, kBlock, regs, local,
                        block, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
