// The step kernels' launch logic on the host, over the device code of
// rtjax_torch/csrc/step_math.cuh compiled as C++ (tests/
// test_torch_step_kernels.py builds it with g++ and binds it with
// kernels/step.py ``bind``, so that the real ctypes wrappers run it on CPU
// tensors).  Each entry point of csrc/step_kernels.cu is a loop over the
// lanes in order, the shared-memory tables as host copies, the atomics as
// plain adds (so the flush adds in index_add_'s order).  The first
// designs' camera rank (the unsorted engine's and the parity modes') runs
// step_math.cuh's look-back scan with every block publishing its count
// first and the blocks then looking back from the last to the first, so
// that each walks its predecessors' aggregates.  The parity modes' route
// and the unsorted engine's route and shade run their blocks interleaved
// in a shuffled order on the persistent scratch (a.scan, interleaved): a
// block takes its ticket, later routes its lanes and publishes its count
// (route and shade: then shades every lane but its camera rays), then
// steps back kRankLook status words at a time (rank_step over the words a
// warp's lanes would read), the scheduler picking at random among the
// blocks yet to take a ticket and those that hold one, so that a block
// meets unpublished words and words of the launch before and is set
// aside at its look-back and resumed; when its walk ends the block takes
// its ranks (route and shade: its camera lanes make their rays).  The
// one-sample shade's resident grid is host_shade_slots blocks, taken in a
// shuffled order, each thread's tile walk (step_math.cuh shade_1s_walk)
// run over the block's stages, filled with a pattern first and kept
// across its tiles; the pipeline's copies land when issued or, with
// host_copies_at_wait, only when a wait completes their group (so that a
// stage overwritten too early, or read before its wait, shows); the flush
// is added in lane order.  The stats resolve's histogram adds each traced
// lane into its 256-lane block's bins, then each block's non-zero bins
// into the histogram.
#include <cmath>
#include <cstring>
#include <algorithm>
#include <utility>
#include <vector>
#define __device__
#define __forceinline__ inline
using std::min; using std::max; using std::isnan; using std::isfinite;
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int2 __ldg(const int2* p) { return *p; }
inline int4 __ldg(const int4* p) { return *p; }
inline unsigned long long atomicExch(unsigned long long* p,
                                     unsigned long long v) {
  const unsigned long long old = *p;
  *p = v;
  return old;
}
inline int __ldg(const int* p) { return *p; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
// the pipeline's copies (cp.async): at issue, or held in their commit group
// until a wait completes it
extern "C" { int host_copies_at_wait = 0; }
struct HostCopy { void* dst; const void* src; size_t bytes; };
static std::vector<HostCopy> open_group;
static std::vector<std::vector<HostCopy>> pending;
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes) {
  if (host_copies_at_wait) open_group.push_back({dst, src, bytes});
  else memcpy(dst, src, bytes);
}
inline void __pipeline_commit() { pending.push_back(open_group); open_group.clear(); }
inline void __pipeline_wait_prior(size_t prior) {
  while (pending.size() > prior) {
    for (const HostCopy& c : pending.front()) memcpy(c.dst, c.src, c.bytes);
    pending.erase(pending.begin());
  }
}
#include "step_math.cuh"
using namespace rtjax_step;

template <bool kV1> static void route(const StepArgs* a) {
  for (int i = 0; i < a->n; ++i) {
    RouteLane r = route_lane<kV1>(*a, i, kV1 ? nullptr : reinterpret_cast<int2*>(a->bundle) + 5LL * i);
    a->counts[0] += r.mat;
    a->counts[4] += r.dirty;
  }
}
struct Staged {  // the block's shared-memory copy
  std::vector<int> mtype, ltype, ltri;
  std::vector<float> albedo, ior, rows[6];
};
static Tables stage(const StepArgs& a, Staged& s) {
  Tables T = global_tables(a);
  s.mtype.assign(a.mtype, a.mtype + a.num_materials);
  s.ior.assign(a.ior, a.ior + a.num_materials);
  s.albedo.assign(a.albedo, a.albedo + 3 * a.num_materials);
  T.mtype = s.mtype.data(); T.ior = s.ior.data(); T.albedo = s.albedo.data();
  if (a.num_light_rows > 0) {
    s.ltype.assign(a.ltype, a.ltype + a.num_light_rows);
    s.ltri.assign(a.ltri, a.ltri + a.num_light_rows);
    const float* src[6] = {a.lpos, a.lemit, a.ltp0, a.lte1, a.lte2, a.ltn};
    for (int t = 0; t < 6; ++t) s.rows[t].assign(src[t], src[t] + 3 * a.num_light_rows);
    T.ltype = s.ltype.data(); T.ltri = s.ltri.data();
    T.lpos = s.rows[0].data(); T.lemit = s.rows[1].data(); T.ltp0 = s.rows[2].data();
    T.lte1 = s.rows[3].data(); T.lte2 = s.rows[4].data(); T.ltn = s.rows[5].data();
  }
  return T;
}
extern "C" int rtjax_step_route(const StepArgs* a, void*) { route<false>(a); return 0; }
extern "C" int rtjax_step_route_v1(const StepArgs* a, void*) { route<true>(a); return 0; }
template <int kMode, bool kOneSample> static int shade_sorted(const StepArgs* a) {
  Staged st;
  const Tables T = stage(*a, st);
  const bool do_gen = cadence(*a);
  long long c1 = 0, c2 = 0, c3 = 0;
  for (int i = 0; i < a->n; ++i) {
    ShadeLane r = shade_lane<false, kMode, kOneSample>(*a, i, T, do_gen);
    c1 += r.trace; c2 += r.nee; c3 += r.mis;
    const long long lo = a->counts[0];
    if (r.flush && i >= lo && i < lo + a->counts[4]) {
      const V3 v = r.flushed;
      float* px = a->fb + 3 * (long long)r.pixel;
      if (v.x != 0.0f) px[0] += v.x;
      if (v.y != 0.0f) px[1] += v.y;
      if (v.z != 0.0f) px[2] += v.z;
    }
  }
  a->counts[1] += c1; a->counts[2] += c2; a->counts[3] += c3;
  return 0;
}
extern "C" int rtjax_step_shade(const StepArgs* a, void*) { return shade_sorted<kDefault, false>(a); }
extern "C" int rtjax_step_shade_1s_v1(const StepArgs* a, void*) { return shade_sorted<kDefault, true>(a); }
extern "C" int rtjax_step_shade_wide(const StepArgs* a, void*) { return shade_sorted<kWide, false>(a); }
extern "C" int rtjax_step_shade_wide_1s(const StepArgs* a, void*) { return shade_sorted<kWide, true>(a); }
extern "C" int rtjax_step_shade_v1(const StepArgs* a, void*) {
  const bool do_gen = cadence(*a);
  long long c1 = 0, c2 = 0, c3 = 0;
  for (int i = 0; i < a->n; ++i) {
    ShadeLane r = shade_lane<true>(*a, i, global_tables(*a), do_gen);
    c1 += r.trace; c2 += r.nee; c3 += r.mis;
    if (r.flush) {
      float* px = a->fb + 3 * (long long)r.pixel;
      px[0] += r.flushed.x; px[1] += r.flushed.y; px[2] += r.flushed.z;
    }
  }
  a->counts[1] += c1; a->counts[2] += c2; a->counts[3] += c3;
  return 0;
}
static unsigned long long shuffle_state = 0x9E3779B97F4A7C15ULL;
static unsigned shuffled(unsigned k) {  // a draw in [0, k)
  shuffle_state = shuffle_state * 6364136223846793005ULL + 1442695040888963407ULL;
  return static_cast<unsigned>(shuffle_state >> 33) % k;
}
// the one-sample shade (step_kernels.cu shade_1s_kernel): a grid of
// min(tiles, host_shade_slots) blocks in a shuffled order, each thread's
// walk over the block's tiles on the block's stages
extern "C" { int host_shade_slots = 3; }
extern "C" int rtjax_step_shade_1s(const StepArgs* a, void*) {
  Staged st;
  const Tables T = stage(*a, st);
  const bool do_gen = cadence(*a);
  const long long lo = a->counts[0], hi = lo + a->counts[4];
  const int tiles = (a->n + kShadeTile - 1) / kShadeTile;
  const int grid = min(tiles, host_shade_slots);
  std::vector<int> order(grid);
  for (int b = 0; b < grid; ++b) order[b] = b;
  for (int b = grid - 1; b > 0; --b) std::swap(order[b], order[shuffled(b + 1)]);
  std::vector<ShadeLane> shaded(a->n);
  std::vector<char> flushes(a->n, 0);
  long long c1 = 0, c2 = 0, c3 = 0;
  for (int b : order) {
    ShadeStages s;
    memset(&s, 0xA5, sizeof s);
    for (int t = 0; t < kShadeTile; ++t) {
      const WalkCounts c = shade_1s_walk(*a, T, s, t, b, grid, do_gen,
          [&](long long i, const ShadeLane& r) {
            shaded[i] = r;
            flushes[i] = r.flush && i >= lo && i < hi;
          });
      c1 += c.trace; c2 += c.nee; c3 += c.mis;
    }
  }
  for (int i = 0; i < a->n; ++i) {
    if (!flushes[i]) continue;
    const V3 v = shaded[i].flushed;
    float* px = a->fb + 3 * (long long)shaded[i].pixel;
    if (v.x != 0.0f) px[0] += v.x;
    if (v.y != 0.0f) px[1] += v.y;
    if (v.z != 0.0f) px[2] += v.z;
  }
  a->counts[1] += c1; a->counts[2] += c2; a->counts[3] += c3;
  return 0;
}
template <int kMode> static int route_full(const StepArgs* a) {
  for (int i = 0; i < a->n; ++i) {
    RouteLane r = route_lane<false, kMode>(*a, i, reinterpret_cast<int2*>(a->bundle) + kFullWords / 2 * (long long)i);
    a->counts[0] += r.mat;
    a->counts[4] += kMode == kWide ? r.dirty : r.limbo;
  }
  return 0;
}
template <int kMode, bool kOneSample = false> static int shade_full(const StepArgs* a) {
  Staged st;
  const Tables T = stage(*a, st);
  const int n = a->n, blocks = (n + kScanBlock - 1) / kScanBlock;
  auto* status = reinterpret_cast<unsigned long long*>(a->scan) + 2;
  std::vector<FullRec> rec(n);
  std::vector<long long> agg(blocks, 0), prefix(blocks, 0);
  for (int i = 0; i < n; ++i) {
    if (kMode == kUnsorted) {  // route and shade in one kernel
      int2 w[kFullWords / 2];
      route_lane<false, kMode>(*a, i, w);
      rec[i] = full_from_words(w);
      a->counts[0] += rec[i].mat;
    } else {
      rec[i] = load_full(*a, (kMode & kUnsorted) ? i : a->order[i]);
    }
    agg[i / kScanBlock] += !rec[i].mat && !rec[i].limbo;
  }
  for (int b = 0; b < blocks; ++b) scan_publish(status, b, agg[b]);
  for (int b = blocks - 1; b >= 0; --b) prefix[b] = scan_lookback(status, b, agg[b]);
  for (int b = 0; b < blocks + 2; ++b) a->scan[b] = 0;  // the last block's reset
  long long c1 = 0, c2 = 0, c3 = 0, rank = 0;
  for (int i = 0; i < n; ++i) {
    if (i % kScanBlock == 0) rank = prefix[i / kScanBlock];
    ShadeLane r = shade_full_lane<kMode, kOneSample>(*a, i, T, rec[i], rank);
    rank += !rec[i].mat && !rec[i].limbo;
    c1 += r.trace; c2 += r.nee; c3 += r.mis;
    if (r.flush) {
      const V3 v = r.flushed;
      float* px = a->fb + 3 * (long long)r.pixel;
      if (v.x != 0.0f) px[0] += v.x;
      if (v.y != 0.0f) px[1] += v.y;
      if (v.z != 0.0f) px[2] += v.z;
    }
  }
  a->counts[1] += c1; a->counts[2] += c2; a->counts[3] += c3;
  return 0;
}
// a ranked launch's ``blocks`` blocks interleaved on the persistent
// ``scratch`` (the ticket, then one status word a block): ``arrive(b)`` a
// block's work before it publishes, returning its count; ``shade(b)`` its
// work between publishing and the look-back; ``done(b, before)`` its work
// after, with its exclusive prefix.  A block takes its ticket, later
// publishes, then looks back a step at a time: the scheduler picks at
// random among the blocks yet to take a ticket and those that hold one,
// so that a walk meets words its predecessors have not published yet
// (theirs from the launch before, or a fresh scratch's zeros) and waits
template <class Arrive, class Shade, class Done>
static void interleaved(unsigned* scratch, int blocks, Arrive arrive,
                        Shade shade, Done done) {
  unsigned* status = scratch + 1;
  struct Block { int b, j; unsigned parity, total, before; bool published, done; };
  std::vector<Block> run;  // the blocks that hold a ticket, in ticket order
  int live = 0;
  while (static_cast<int>(run.size()) < blocks || live > 0) {
    const int waiting = blocks - static_cast<int>(run.size());
    const unsigned pick = shuffled(static_cast<unsigned>(waiting + live));
    if (static_cast<int>(pick) < waiting) {  // a block takes its ticket
      const unsigned t = scratch[0];
      scratch[0] = t >= rank_ticket_limit(blocks) ? 0u : t + 1u;
      run.push_back({rank_block(t, blocks), 0, rank_parity(t, blocks), 0, 0,
                     false, false});
      ++live;
      continue;
    }
    int m = static_cast<int>(pick) - waiting;
    Block* k = nullptr;
    for (Block& x : run) if (!x.done && m-- == 0) { k = &x; break; }
    if (!k->published) {  // it routes, publishes its count and shades
      k->total = arrive(k->b);
      status[k->b] = rank_word(k->parity, k->b == 0, k->total);
      shade(k->b);
      k->published = true;
      k->j = k->b - 1;
      if (k->b == 0) {
        k->done = true;
        --live;
        done(k->b, 0u);
      }
      continue;
    }
    // one look-back step
    unsigned w[kRankLook], unpub = 0, pre = 0;
    for (int l = 0; l < kRankLook; ++l) {
      w[l] = k->j - l >= 0 ? status[k->j - l] : rank_word(k->parity, true, 0);
      const bool pub = rank_published(w[l], k->parity);
      unpub |= (!pub ? 1u : 0u) << l;
      pre |= (pub && (w[l] & kRankPrefix) ? 1u : 0u) << l;
    }
    const RankStep st = rank_step(unpub, pre);
    for (int l = 0; l < kRankLook; ++l)
      if ((st.take >> l) & 1u) k->before += w[l] & kRankValue;
    if (st.back >= 0) { k->j -= st.back; continue; }
    status[k->b] = rank_word(k->parity, true, k->before + k->total);
    k->done = true;
    --live;
    done(k->b, k->before);
  }
}
template <int kMode> static int route_ranked(const StepArgs* a) {
  const int n = a->n, blocks = (n + kRankBlock - 1) / kRankBlock;
  auto rec = [&](int i) { return a->bundle + kFullWords * (long long)i; };
  interleaved(reinterpret_cast<unsigned*>(a->scan), blocks, [&](int b) {
    unsigned total = 0;
    for (int i = b * kRankBlock; i < min(n, (b + 1) * kRankBlock); ++i) {
      RouteLane r = route_lane<false, kMode>(*a, i, reinterpret_cast<int2*>(rec(i)));
      a->counts[0] += r.mat;
      a->counts[4] += r.limbo;
      total += !r.mat && !r.limbo;
    }
    return total;
  }, [](int) {}, [&](int b, unsigned before) {  // the ranks into word 22
    int rank = static_cast<int>(before);
    for (int i = b * kRankBlock; i < min(n, (b + 1) * kRankBlock); ++i) {
      rec(i)[22] = rank;
      rank += !(rec(i)[20] & 1) && !(rec(i)[20] & 2);
    }
  });
  return 0;
}
// the unsorted engine's route and shade (step_kernels.cu route_shade): a
// block routes and counts its camera lanes, publishes, shades every lane
// but the camera rays (shade_full_math; the continuing lanes' state
// stored, the flush kept for index_add_'s lane order), looks back, then
// its camera lanes make their rays by rank (camera_full); the counts as
// the kernel's (traced_lanes)
template <bool kOneSample> static int route_shade(const StepArgs* a) {
  Staged st;
  const Tables T = stage(*a, st);
  const int n = a->n, blocks = (n + kScanBlock - 1) / kScanBlock;
  std::vector<FullRec> rec(n);
  std::vector<ShadeLane> shaded(n);
  std::vector<unsigned> total(blocks);
  auto lanes = [&](int b) { return std::make_pair(b * kScanBlock, min(n, (b + 1) * kScanBlock)); };
  interleaved(reinterpret_cast<unsigned*>(a->scan), blocks, [&](int b) {
    for (int i = lanes(b).first; i < lanes(b).second; ++i) {
      int2 w[kFullWords / 2];
      route_lane<false, kUnsorted>(*a, i, w);
      rec[i] = full_from_words(w);
      total[b] += !rec[i].mat;
    }
    return total[b];
  }, [&](int b) {
    for (int i = lanes(b).first; i < lanes(b).second; ++i) {
      const FullShade f = shade_full_math<kUnsorted, kOneSample>(*a, i, T, rec[i]);
      shaded[i] = f.s;
      if (rec[i].mat) store_full<kUnsorted>(*a, i, rec[i], f, CameraRay{});
      a->counts[2] += f.s.nee;
      a->counts[3] += f.s.mis;
    }
  }, [&](int b, unsigned before) {
    const int valid = lanes(b).second - lanes(b).first;
    a->counts[0] += valid - total[b];
    a->counts[1] += traced_lanes(*a, valid, total[b], before);
    long long rank = before;
    for (int i = lanes(b).first; i < lanes(b).second; ++i)
      if (!rec[i].mat)
        store_full<kUnsorted>(*a, i, rec[i], FullShade{}, camera_full(*a, i, rank++));
  });
  for (int i = 0; i < n; ++i) {
    const V3 v = shaded[i].flushed;
    float* px = a->fb + 3 * (long long)shaded[i].pixel;
    if (!shaded[i].flush) continue;
    if (v.x != 0.0f) px[0] += v.x;
    if (v.y != 0.0f) px[1] += v.y;
    if (v.z != 0.0f) px[2] += v.z;
  }
  return 0;
}
extern "C" int rtjax_step_route_parity(const StepArgs* a, void*) { return route_ranked<kParity>(a); }
extern "C" int rtjax_step_route_parity_unsorted(const StepArgs* a, void*) { return route_ranked<kParityUnsorted>(a); }
extern "C" int rtjax_step_route_parity_v1(const StepArgs* a, void*) { return route_full<kParity>(a); }
extern "C" int rtjax_step_route_parity_unsorted_v1(const StepArgs* a, void*) { return route_full<kParityUnsorted>(a); }
extern "C" int rtjax_step_route_shade_unsorted(const StepArgs* a, void*) { return route_shade<false>(a); }
extern "C" int rtjax_step_route_shade_unsorted_1s(const StepArgs* a, void*) { return route_shade<true>(a); }
extern "C" int rtjax_step_route_shade_unsorted_v1(const StepArgs* a, void*) { return shade_full<kUnsorted>(a); }
extern "C" int rtjax_step_route_shade_unsorted_1s_v1(const StepArgs* a, void*) { return shade_full<kUnsorted, true>(a); }
extern "C" int rtjax_step_route_wide(const StepArgs* a, void*) { return route_full<kWide>(a); }
template <int kMode> static int shade_ranked(const StepArgs* a) {
  Staged st;
  const Tables T = stage(*a, st);
  long long c1 = 0, c2 = 0, c3 = 0;
  for (int i = 0; i < a->n; ++i) {
    const FullRec r = load_full(*a, (kMode & kUnsorted) ? i : a->order[i]);
    ShadeLane s = shade_full_lane<kMode>(*a, i, T, r, r.rank);
    c1 += s.trace; c2 += s.nee; c3 += s.mis;
    if (s.flush) {
      const V3 v = s.flushed;
      float* px = a->fb + 3 * (long long)s.pixel;
      if (v.x != 0.0f) px[0] += v.x;
      if (v.y != 0.0f) px[1] += v.y;
      if (v.z != 0.0f) px[2] += v.z;
    }
  }
  a->counts[1] += c1; a->counts[2] += c2; a->counts[3] += c3;
  return 0;
}
extern "C" int rtjax_step_shade_parity(const StepArgs* a, void*) { return shade_ranked<kParity>(a); }
extern "C" int rtjax_step_shade_parity_unsorted(const StepArgs* a, void*) { return shade_ranked<kParityUnsorted>(a); }
extern "C" int rtjax_step_shade_parity_v1(const StepArgs* a, void*) { return shade_full<kParity>(a); }
extern "C" int rtjax_step_shade_parity_unsorted_v1(const StepArgs* a, void*) { return shade_full<kParityUnsorted>(a); }
// the stats resolve's histogram (step_kernels.cu hist_begin / hist_end):
// each traced lane into its 256-lane block's bins, each block's non-zero
// bins into the histogram; past kSmemBins bins each traced lane adds to
// the histogram
static void hist_around(const StepArgs* a) {
  constexpr int kBlock = 256, kSmemBins = 4096;
  const int nb = a->max_bounces + 1, n = a->n;
  if (nb > kSmemBins) {
    for (int i = 0; i < n; ++i) if (hist_bin(*a, i) >= 0) a->hist[hist_bin(*a, i)] += 1;
    return;
  }
  for (int lo = 0; lo < n; lo += kBlock) {
    std::vector<int> bins(nb, 0);
    for (int i = lo; i < min(n, lo + kBlock); ++i)
      if (hist_bin(*a, i) >= 0) bins[hist_bin(*a, i)] += 1;
    for (int k = 0; k < nb; ++k) if (bins[k] != 0) a->hist[k] += bins[k];
  }
}
// kStats 1: hist_around; 2: the first design's (each traced lane added)
template <bool kRestore, bool kOneSample, int kStats> static int resolve(const StepArgs* a) {
  if (kStats == 1) hist_around(a);
  for (int i = 0; i < a->n; ++i) {
    if (kStats == 2 && hist_bin(*a, i) >= 0) a->hist[hist_bin(*a, i)] += 1;
    if (a->num_lights > 0) resolve_lane<kOneSample>(*a, i);
    if (kRestore) restore_limbo(*a, i);
  }
  resolve_counters<kRestore ? kParity : kDefault>(*a);
  return 0;
}
extern "C" int rtjax_step_resolve(const StepArgs* a, void*) { return resolve<false, false, 0>(a); }
extern "C" int rtjax_step_resolve_1s(const StepArgs* a, void*) { return resolve<false, true, 0>(a); }
extern "C" int rtjax_step_resolve_stats(const StepArgs* a, void*) { return resolve<false, false, 1>(a); }
extern "C" int rtjax_step_resolve_1s_stats(const StepArgs* a, void*) { return resolve<false, true, 1>(a); }
extern "C" int rtjax_step_resolve_parity(const StepArgs* a, void*) { return resolve<true, false, 0>(a); }
extern "C" int rtjax_step_resolve_parity_stats(const StepArgs* a, void*) { return resolve<true, false, 1>(a); }
extern "C" int rtjax_step_resolve_parity_stats_v1(const StepArgs* a, void*) { return resolve<true, false, 2>(a); }
extern "C" int rtjax_step_kernel_info(int, int* r, int* l, int* b, int* k) {
  *r = *l = *b = *k = 0; return 0;
}
