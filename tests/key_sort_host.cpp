// The stable key sort's launch logic on the host, over the arithmetic of
// rtjax_torch/csrc/key_sort.cuh compiled as C++ (tests/
// test_torch_key_sort.py builds it with g++ and binds it with
// kernels/sort.py ``bind``, so that the real ctypes wrapper runs it on CPU
// tensors).  It exports the library's entry points and runs what the
// kernels run, serially, on the persistent scratch as the launch before
// left it (nothing zeroed): the cadence; the upsweep block by block, each
// taking its ticket (the launch's parity) and adding its keys' digits to
// the histogram plane of that parity, the first block zeroing the other
// plane; then each pass tile by tile in ticket order with the kernels'
// tile and digit sizes: the warps' ballots of digit bits, the ranks
// within a warp, the warps' counters made exclusive, the status words
// published and read back by the look-back with the launch's tag, the
// digits' offsets scanned from the histogram, the tile staged in sorted
// order and scattered.  The condition kernel's stand-in writes the if
// node's condition to the word ``handle`` points at.  the first design
// (rtjax_key_sort_v1) runs as before: its counters zeroed, tags of its
// own.
#include <cstring>
#include <vector>
#define __host__
#define __device__
#include "key_sort.cuh"
using namespace rtjax_sort;

namespace {

constexpr int kNotOnCard = 1;   // kernel info: no card here
constexpr int kBadArgs = 2;
constexpr int kLookBack = 3;    // a status word read before it was written

// the ballots of peers_of (csrc/key_sort.cu): lane l's peers among ``d``
unsigned peers_of(const unsigned* d, const bool* valid, int lane) {
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= valid[l] ? 1u << l : 0u;
  for (int b = 0; b < kBits; ++b) {
    unsigned v = 0;
    for (int l = 0; l < 32; ++l) v |= ((d[l] >> b) & 1u) ? 1u << l : 0u;
    m &= ((d[lane] >> b) & 1u) ? v : ~v;
  }
  return m;
}

// atomicInc: the old value, and the counter set to 0 past ``limit``
unsigned take(unsigned* counter, unsigned limit) {
  const unsigned old = *counter;
  *counter = old >= limit ? 0u : old + 1u;
  return old;
}

// a thread's keys' digits of every pass added to ``hist`` (``items`` keys
// a thread, ``first`` the block's first key)
void count_keys(const int* keys, int n, long long first, int items, int t,
                unsigned* hist) {
  for (int k = 0; k < items; ++k) {
    const long long i = first + static_cast<long long>(k) * kBlock + t;
    if (i >= n) break;
    for (int p = 0; p < kPasses; ++p)
      hist[p * kRadix + digit(flip(keys[i]), p)] += 1;
  }
}

// One tile of a pass ranked as a block of ``Warps`` warps of ``Items``
// keys a thread ranks it (``Offset`` its item_offset): its keys and
// indices, each key's rank in its warp, the warps' counters made
// exclusive and the tile's count of each digit; then staged in sorted
// order and scattered, ``before[d]`` the digit's count over the pass's
// keys before the tile and ``hist`` the pass's histogram.
template <int Warps, int Items, int (*Offset)(int, int, int)>
struct Tile {
  static constexpr int kKeys = Warps * 32 * Items;
  std::vector<unsigned> key, count;
  std::vector<int> idx, rank;
  std::vector<unsigned short> cnt;
  Tile() : key(kKeys), count(kRadix), idx(kKeys), rank(kKeys),
           cnt(Warps * kRadix) {}

  void rank_keys(const int* keys, const unsigned* in, int n, int p,
                 long long first) {
    const int r = kRadix;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int w = 0; w < Warps; ++w)
      for (int k = 0; k < Items; ++k) {
        unsigned d[32];
        bool valid[32];
        int before[32];
        for (int ln = 0; ln < 32; ++ln) {
          const int o = Offset(w, k, ln);
          const long long i = first + o;
          valid[ln] = i < n;
          key[o] = valid[ln] ? (p == 0 ? flip(keys[i]) : in[2 * i]) : 0u;
          idx[o] = valid[ln] ? (p == 0 ? static_cast<int>(i)
                                       : static_cast<int>(in[2 * i + 1]))
                             : 0;
          d[ln] = digit(key[o], p);
          before[ln] = valid[ln] ? cnt[w * r + d[ln]] : 0;
        }
        for (int ln = 0; ln < 32; ++ln) {
          const unsigned peers = peers_of(d, valid, ln);
          if (valid[ln] && ln == leader(peers))
            cnt[w * r + d[ln]] =
                static_cast<unsigned short>(before[ln] + popc(peers));
          rank[Offset(w, k, ln)] = warp_rank(before[ln], peers, ln);
        }
      }
    for (int dd = 0; dd < r; ++dd) {
      unsigned sum = 0;
      for (int w = 0; w < Warps; ++w) {
        const unsigned c = cnt[w * r + dd];
        cnt[w * r + dd] = static_cast<unsigned short>(sum);
        sum += c;
      }
      count[dd] = sum;
    }
  }

  void scatter(const unsigned* hist, const unsigned* before, int n, int p,
               long long first, long long* order, unsigned* out) const {
    const int r = kRadix;
    std::vector<unsigned> skey(kKeys);
    std::vector<int> sidx(kKeys), tstart(r), base(r);
    unsigned in_tile = 0, global = 0;
    for (int d = 0; d < r; ++d) {
      tstart[d] = static_cast<int>(in_tile);
      base[d] = static_cast<int>(global + before[d]) -
                static_cast<int>(in_tile);
      in_tile += count[d];
      global += hist[d];
    }
    for (int w = 0; w < Warps; ++w)
      for (int k = 0; k < Items; ++k)
        for (int ln = 0; ln < 32; ++ln) {
          const int o = Offset(w, k, ln);
          if (first + o >= n) continue;
          const unsigned d = digit(key[o], p);
          const int at = tstart[d] + cnt[w * r + d] + rank[o];
          skey[at] = key[o];
          sidx[at] = idx[o];
        }
    const long long left = n - first;
    const int tile_n = left < kKeys ? static_cast<int>(left) : kKeys;
    for (int j = 0; j < tile_n; ++j) {
      const long long dst = base[digit(skey[j], p)] + j;
      if (p == kPasses - 1) {
        order[dst] = sidx[j];
      } else {
        out[2 * dst] = skey[j];
        out[2 * dst + 1] = static_cast<unsigned>(sidx[j]);
      }
    }
  }
};

void upsweep(const int* keys, int n, unsigned char* s) {
  const Layout l = layout(n);
  unsigned* counters = reinterpret_cast<unsigned*>(s + l.counters);
  unsigned* planes = reinterpret_cast<unsigned*>(s + l.hist);
  const int blocks = upsweep_blocks(n);
  for (int blk = 0; blk < blocks; ++blk) {
    const unsigned parity = launch_parity(
        take(counters + kUpTicket, ticket_limit(blocks)), blocks);
    if (blk == 0)
      std::memset(planes + (parity ^ 1u) * plane_words(), 0,
                  4 * plane_words());
    for (int t = 0; t < kBlock; ++t)
      count_keys(keys, n, static_cast<long long>(blk) * kBlock * kUpItems,
                 kUpItems, t, planes + parity * plane_words());
  }
}

int pass(const int* keys, long long* order, unsigned char* s, int n, int p) {
  const Layout l = layout(n);
  const int r = kRadix, tiles = num_tiles(n);
  const unsigned* in = reinterpret_cast<const unsigned*>(
      s + ((p & 1) ? l.pairs0 : l.pairs1));
  unsigned* out = reinterpret_cast<unsigned*>(s + ((p & 1) ? l.pairs1
                                                           : l.pairs0));
  unsigned* counters = reinterpret_cast<unsigned*>(s + l.counters);
  unsigned* status = reinterpret_cast<unsigned*>(s + l.status) +
                     static_cast<long long>(p) * tiles * r;
  Tile<kWarps, kItems, item_offset> tl;
  std::vector<unsigned> before(r);
  for (int b = 0; b < tiles; ++b) {
    const unsigned ticket = take(counters + 1 + p, ticket_limit(tiles));
    const unsigned parity = launch_parity(ticket, tiles);
    const int t = ticket_index(ticket, tiles);
    const long long first = static_cast<long long>(t) * kTile;
    const unsigned* hist = reinterpret_cast<const unsigned*>(s + l.hist) +
                           parity * plane_words() + p * r;
    tl.rank_keys(keys, in, n, p, first);
    for (int d = 0; d < r; ++d)
      status[static_cast<long long>(t) * r + d] =
          status_word(parity, t == 0, tl.count[d]);
    for (int d = 0; d < r; ++d) {
      before[d] = 0;
      if (t == 0) continue;
      for (int j = t - 1;;) {
        unsigned w[kLook];
        for (int q = 0; q < kLook; ++q)
          w[q] = j - q >= 0 ? status[static_cast<long long>(j - q) * r + d]
                            : status_word(parity, true, 0);
        const int back = lookback_step(w, parity, before[d]);
        if (back < 0) break;
        if (back < kLook) return kLookBack;   // all are published here
        j -= back;
      }
      status[static_cast<long long>(t) * r + d] =
          status_word(parity, true, before[d] + tl.count[d]);
    }
    tl.scatter(hist, before.data(), n, p, first, order, out);
  }
  return 0;
}

// the first design on its zeroed scratch
namespace first_design {

void upsweep(const int* keys, int n, unsigned* hist) {
  for (int blk = 0; blk < v1::upsweep_blocks(n); ++blk)
    for (int t = 0; t < kBlock; ++t)
      count_keys(keys, n, static_cast<long long>(blk) * kBlock * v1::kUpItems,
                 v1::kUpItems, t, hist);
}

int pass(const int* keys, long long* order, unsigned char* s, int n, int p) {
  const v1::Layout l = v1::layout(n);
  const int r = kRadix, tiles = v1::num_tiles(n);
  const unsigned* in = reinterpret_cast<const unsigned*>(
      s + ((p & 1) ? l.pairs0 : l.pairs1));
  unsigned* out = reinterpret_cast<unsigned*>(s + ((p & 1) ? l.pairs1
                                                           : l.pairs0));
  const unsigned* hist = reinterpret_cast<const unsigned*>(s + l.hist) + p * r;
  unsigned* ticket = reinterpret_cast<unsigned*>(s + l.tickets) + p;
  unsigned* status = reinterpret_cast<unsigned*>(s + l.status) +
                     static_cast<long long>(p) * tiles * r;
  Tile<kWarps, v1::kItems, v1::item_offset> tl;
  std::vector<unsigned> before(r);
  for (int b = 0; b < tiles; ++b) {
    const int t = static_cast<int>((*ticket)++);
    const long long first = static_cast<long long>(t) * v1::kTile;
    tl.rank_keys(keys, in, n, p, first);
    for (int d = 0; d < r; ++d)
      status[static_cast<long long>(t) * r + d] = v1::status_word(
          t == 0 ? v1::kPrefix : v1::kAggregate, tl.count[d]);
    for (int d = 0; d < r; ++d) {
      before[d] = 0;
      if (t == 0) continue;
      for (int j = t - 1;;) {
        unsigned w[kLook];
        for (int q = 0; q < kLook; ++q)
          w[q] = j - q >= 0 ? status[static_cast<long long>(j - q) * r + d]
                            : v1::kPrefix;
        const int back = v1::lookback_step(w, before[d]);
        if (back < 0) break;
        if (back < kLook) return kLookBack;
        j -= back;
      }
      status[static_cast<long long>(t) * r + d] =
          v1::status_word(v1::kPrefix, before[d] + tl.count[d]);
    }
    tl.scatter(hist, before.data(), n, p, first, order, out);
  }
  return 0;
}

}  // namespace first_design

}  // namespace

extern "C" long long rtjax_key_sort_scratch_bytes(int n) {
  return layout(n).total;
}

extern "C" int rtjax_key_sort(const int* keys, long long* order,
                              void* scratch, int n, const long long* counts,
                              const long long* it, long long it_value,
                              int sort_every, unsigned long long* tally,
                              void*) {
  if (n <= 0) return 0;
  if (n > kMaxKeys) return kBadArgs;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const bool full = cadence(counts, it, it_value, sort_every, n);
  if (tally != nullptr) tally[full ? 0 : 1] += 1;
  if (!full) return 0;
  upsweep(keys, n, s);
  for (int p = 0; p < kPasses; ++p) {
    const int rc = pass(keys, order, s, n, p);
    if (rc != 0) return rc;
  }
  return 0;
}

extern "C" int rtjax_key_sort_condition(unsigned long long handle,
                                        const long long* counts,
                                        const long long* it,
                                        long long it_value, int sort_every,
                                        int n, unsigned long long* tally,
                                        void*) {
  const bool full = cadence(counts, it, it_value, sort_every, n);
  if (tally != nullptr) tally[full ? 0 : 1] += 1;
  *reinterpret_cast<unsigned*>(handle) = full ? 1u : 0u;
  return 0;
}

extern "C" long long rtjax_key_sort_v1_scratch_bytes(int n) {
  return v1::layout(n).total;
}

extern "C" int rtjax_key_sort_v1(const int* keys, long long* order,
                                 void* scratch, int n,
                                 const long long* counts,
                                 const long long* it, long long it_value,
                                 int sort_every, unsigned long long* tally,
                                 void*) {
  if (n <= 0) return 0;
  if (n > kMaxKeys) return kBadArgs;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const v1::Layout l = v1::layout(n);
  std::memset(s, 0, l.zeroed);
  const bool full = cadence(counts, it, it_value, sort_every, n);
  if (tally != nullptr) tally[full ? 0 : 1] += 1;
  if (!full) return 0;
  first_design::upsweep(keys, n, reinterpret_cast<unsigned*>(s + l.hist));
  for (int p = 0; p < kPasses; ++p) {
    const int rc = first_design::pass(keys, order, s, n, p);
    if (rc != 0) return rc;
  }
  return 0;
}

extern "C" int rtjax_key_sort_kernel_info(int, int*, int*, int*, int*) {
  return kNotOnCard;
}
