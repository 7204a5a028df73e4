#!/usr/bin/env python3
"""The redesigned kernels (persistent walkers, two-level or packet kernels)
against each part of their design undone, on one CUDA card.

    python3 tools/persist_variants.py
        [--kernels persist|two-level|packet|lane] [--only NAME,NAME]
        [--config4] [--rounds R]

Each variant is a copy of the kernel source (``csrc/persist_traverse.cu``,
``csrc/wide_inst_traverse.cu`` or ``csrc/packet_traverse.cu``) and of its
walk header (``csrc/fetch_walk.cuh``, or ``csrc/packet_walk.cuh`` for the
packet kernels, ``csrc/lane_walk.cuh`` for the lane kernels) with a few
lines replaced (``VARIANTS``, ``INST_VARIANTS``, ``PACKET_VARIANTS``,
``LANE_VARIANTS``: each replaced text must occur exactly once in the two
files, or the tool stops), built into
``build/rtjax_torch/variants/<kernels>_<variant>/``, all builds started
together; ptxas's registers, stack frame and spills of its kernels are
printed.  Then, for the persist kernels, it renders one headline frame
with the shipped kernels and keeps the rays of launch
``chip_smoke.CAPTURE_AT`` of each, and on those and on ``chip_smoke.py``'s
phase-3 rays (2^18 closest-hit, 2^19 any-hit rays over the headline scene)
-- with ``--config4`` also on its phase-5 rays over config 4's baked
tables and its BLAS -- holds every variant bit for bit against the plain
versions and times it; the packet kernels the same, the frame rendered under
``walker="packet"`` and each variant held against the plain group walk at
its own packet size (``PACKET_GROUPS``); the lane kernels the same, the
frame rendered under ``walker="lane"`` (its closest-hit launch and the
persist any-hit launch of the same iteration) and held against the plain
group walk at ``lane.LANE``; for the two-level kernels the same
on ``chip_smoke.py``'s phase-5 field rays over config 4, over
``chip_smoke.MANY_INST`` instances, and on the rays of launch
``chip_smoke.C4_CAPTURE_AT`` of a config-4 ``two_level="kernel"`` frame.
Times are device time per launch (``chip_smoke._launch_ms``: mean, least
and most of ``chip_smoke.REPS`` launches), every variant and the first
design (stride, the leader design for the packet kernels, the group design
for the lane kernels) in turns,
``--rounds`` rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_FETCH_BOUNDS = "__launch_bounds__(kFetchBlock)\nfetch_kernel"
_INST_BOUNDS = "__launch_bounds__(kFetchBlock)\ninst_fetch"
_SHARED_STACK = """  extern __shared__ int stack[];
  int* st_node = stack + threadIdx.x;
  unsigned* st_mask =
      reinterpret_cast<unsigned*>(stack + stack_len * kFetchBlock) +
      threadIdx.x;"""
_SCALAR_LOADS = [
    ("leaf_any_v<kLeafChunk>(", "leaf_any("),
    ("leaf_closest_v<kLeafChunk>(", "leaf_closest("),
    ("slab_hits_v<W>(", "slab_hits<W>(")]
_REFILL = "if (__popc(want) < Job::kRefill) break;"
_REFILL_8 = [(_REFILL, "if (__popc(want) < 8) break;")]
_REFILL_32 = [(_REFILL, "if (__popc(want) < 32) break;")]


def _cap(min_blocks):
    return [(_FETCH_BOUNDS, f"__launch_bounds__(kFetchBlock, {min_blocks})"
                            "\nfetch_kernel")]


# name -> [(text of the source or header, its replacement)]
VARIANTS = {
    "design": [],
    "leaf chunk 1": [("kLeafChunk = 4;", "kLeafChunk = 1;")],
    "leaf chunk 2": [("kLeafChunk = 4;", "kLeafChunk = 2;")],
    "leaf chunk 8": [("kLeafChunk = 4;", "kLeafChunk = 8;")],
    "block 256": [("kFetchBlock = 128;", "kFetchBlock = 256;")],
    "block 64": [("kFetchBlock = 128;", "kFetchBlock = 64;")],
    "<= 80 registers": _cap(6),
    "<= 64 registers": _cap(8),
    "<= 40 registers": _cap(12),
    "refill at 8 empty lanes": _REFILL_8,
    "no dynamic fetch (refill at 32)": _REFILL_32,
    "scalar loads": _SCALAR_LOADS,
    "local-memory stack": [
        (_SHARED_STACK, "  int st_node[kStack];\n  unsigned st_mask[kStack];"),
        ("st_node[s.sp * kFetchBlock]", "st_node[s.sp]"),
        ("st_mask[s.sp * kFetchBlock]", "st_mask[s.sp]"),
        ("top = (s.sp - 1) * kFetchBlock;", "top = s.sp - 1;"),
        ("smem = 2 * 4 * stack_len * kFetchBlock;", "smem = 0;")],
}

# the two-level kernels: each part of their design undone
INST_VARIANTS = {
    "design": [],
    "records from global memory": [(
        "  if (stride) return launch_stride<W, ANY>(tb, in, rays, n, out, s);",
        "  if (stride) return launch_stride<W, ANY>(tb, in, rays, n, out, s);"
        "\n  staged = false;")],
    "rescan every instance": [(
        ": *near;", ": (low == 64 ? ~0ull : (1ull << low) - 1ull);")],
    "scalar loads": _SCALAR_LOADS,
    "leaf chunk 1": [("kLeafChunk = 4;", "kLeafChunk = 1;")],
    "refill at every empty lane": [("kRefill = 8;", "kRefill = 1;")],
    "no dynamic fetch (refill at 32)": _REFILL_32,
    "world ray read again at each entry": [
        ("  Ray world;                // the ray in world space\n", ""),
        ("    const Ray& w = world;\n",
         "    const Ray w = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, "
         "rays.dy, rays.dz, i);\n"),
        ("      world = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, "
         "rays.dz,\n                       i);\n", "")],
    "<= 102 registers": [(_INST_BOUNDS, _INST_BOUNDS.replace(
        "(kFetchBlock)", "(kFetchBlock, 5)"))],
    "<= 85 registers": [(_INST_BOUNDS, _INST_BOUNDS.replace(
        "(kFetchBlock)", "(kFetchBlock, 6)"))],
}


# the packet kernels: each part of their design undone
_LEAF_ROW = "lt + (size_t)(sh.meta[buf][c] >> 4) * 128"
PACKET_VARIANTS = {
    "design": [],
    "scalar loads from global memory": [(
        "slab_hits_s<W>(sh.row[buf], sh.meta[buf], lm, r, tmax)",
        "slab_hits<W>(nb + (size_t)cur * 128, cm + (size_t)cur * W, lm, r, "
        "tmax)")],
    "no next-node overlap": [(
        "      if (leader) stage_node<W>(sh, buf ^ 1, nb, cm, next);\n",
        "      if (leader) stage_node<W>(sh, buf ^ 1, nb, cm, next);\n"
        "      mbar_wait(&sh.node_bar[buf ^ 1], (phase >> (buf ^ 1)) & 1u);\n")],
    "unstaged leaves": [
        ("      if (leader) stage_leaves<W>(sh, slots, sh.meta[buf], lt);\n"
         "      mbar_wait(&sh.leaf_bar, (phase >> 2) & 1u);\n"
         "      phase ^= 4u;\n", ""),
        ("leaf_any_s(sh.leaf[c], count_c,",
         f"leaf_any_v<4>({_LEAF_ROW}, count_c,"),
        ("leaf_closest_s(sh.leaf[c], count_c,",
         f"leaf_closest_v<4>({_LEAF_ROW}, count_c,")],
    "two barriers": [("    int next_info = 0;\n",
                      "    packet_sync(bar);\n    int next_info = 0;\n")],
    # one-warp packets only: the warp's votes need no slots or barrier
    "warp-synchronous step": [(
        """    if (lane == 0) {
      sh.inner[par][warp] = wi;
      sh.leaves[par][warp] = wl;
    }
    packet_sync(bar);
    unsigned u = 0u, slots = 0u;
#pragma unroll
    for (int j = 0; j < kPacketWarps; ++j) {
      u |= sh.inner[par][j];
      slots |= sh.leaves[par][j];
    }
""", """    __syncwarp();
    unsigned u = wi, slots = wl;
""")],
    "pop through the parent's meta": [
        ("        stack[k] = sh.meta[buf][c] >> 4;",
         "        stack[k] = (cur << 4) | c;"),
        ("      next = stack[--sp];",
         "      const int e = stack[--sp];\n"
         "      next = __ldg(cm + (size_t)(e >> 4) * W + (e & 15)) >> 4;")],
    "packet 32 x1 a block": [("kPackets = 4;", "kPackets = 1;")],
    "packet 32 x2 a block": [("kPackets = 4;", "kPackets = 2;")],
    "packet 64 x2 a block": [("kPacket = 32;", "kPacket = 64;"),
                             ("kPackets = 4;", "kPackets = 2;")],
    "packet 64 x4 a block": [("kPacket = 32;", "kPacket = 64;")],
    "packet 128": [("kPacket = 32;", "kPacket = 128;"),
                   ("kPackets = 4;", "kPackets = 1;")],
    "packet 256": [("kPacket = 32;", "kPacket = 256;"),
                   ("kPackets = 4;", "kPackets = 1;")],
}
# rays per packet of each packet variant that changes it
PACKET_GROUPS = {"packet 64 x2 a block": 64, "packet 64 x4 a block": 64,
                 "packet 128": 128, "packet 256": 256}

# the lane kernels: each part of their design undone
_DECIDE = "    int next = advance();\n"
_STOP = "    if (next < 0) return;"
_LANE_DRAW = """  while (true) {
    unsigned g = 0u;
    if (lane == 0) g = atomicAdd(work, 1u);  // the warp's next group
    g = __shfl_sync(kAllLanes, g, 0);
"""
_LANE_ROW = "tb.lt + (size_t)(meta[c] >> 4) * 128"
# the node row staged by a 16-byte word per lane (the design)
_REG_STAGE = """template <int W>
struct NodeStage {
  float4 word;

  __device__ __forceinline__ void start(LaneShared<W>& sh, int buf,
                                        const float* __restrict__ nb,
                                        const int* __restrict__ cm,
                                        int node, int lane) {
    if (lane < 3 * W / 2) {
      word = __ldg(reinterpret_cast<const float4*>(nb + (size_t)node * 128) +
                   lane);
    } else if (lane < 7 * W / 4) {
      const int4 m = __ldg(reinterpret_cast<const int4*>(
                               cm + (size_t)node * W) + lane - 3 * W / 2);
      word = make_float4(__int_as_float(m.x), __int_as_float(m.y),
                         __int_as_float(m.z), __int_as_float(m.w));
    }
  }

  __device__ __forceinline__ void land(LaneShared<W>& sh, int buf,
                                       int lane) {
    if (lane < 7 * W / 4)
      reinterpret_cast<float4*>(sh.node[buf])[lane] = word;
    __syncwarp();
  }
};"""
# the node row copied by one lane with cp.async.bulk on an mbarrier per
# buffer (packet_walk.cuh's copies), in place of a 16-byte word per lane
_BULK_STAGE = """template <int W>
struct NodeStage {
  unsigned phase = 0u;  // parity of each buffer's next phase
  bool ready = false;   // the warp's mbarriers are initialised

  __device__ __forceinline__ unsigned long long* bar(int buf) {
    __shared__ unsigned long long bars[kLaneThreads / 32][2];
    return &bars[threadIdx.x >> 5][buf];
  }

  __device__ __forceinline__ void start(LaneShared<W>& sh, int buf,
                                        const float* __restrict__ nb,
                                        const int* __restrict__ cm,
                                        int node, int lane) {
    __syncwarp();
    if (!ready) {
      if (lane == 0) {
        mbar_init(bar(0));
        mbar_init(bar(1));
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncwarp();
      ready = true;
    }
    if (lane == 0) {
      fence_async_shared();
      mbar_expect(bar(buf), 28 * W);
      bulk_copy(sh.node[buf], nb + (size_t)node * 128, 24 * W, bar(buf));
      bulk_copy(sh.node[buf] + 6 * W, cm + (size_t)node * W, 4 * W,
                bar(buf));
    }
  }

  __device__ __forceinline__ void land(LaneShared<W>& sh, int buf,
                                       int lane) {
    mbar_wait(bar(buf), (phase >> buf) & 1u);
    phase ^= 1u << buf;
  }
};"""
LANE_VARIANTS = {
    "design": [],
    "bulk copies": [(_REG_STAGE, _BULK_STAGE)],
    # rtjax's lane rule: any hit decides after the leaf tests
    "decide after (any hit)": [
        (_DECIDE, "    int next = ANY ? -1 : advance();\n"),
        (_STOP, "    if (ANY) next = advance();\n" + _STOP)],
    "no next-node overlap (closest hit)": [
        (_DECIDE, "    int next = ANY ? advance() : -1;\n"),
        (_STOP, "    if (!ANY) next = advance();\n" + _STOP)],
    "4 warps a block": [("kLaneWarps = 8;", "kLaneWarps = 4;")],
    "16 warps a block": [("kLaneWarps = 8;", "kLaneWarps = 16;")],
    "static grid": [
        (_LANE_DRAW, "  for (int once = 0; once < 1; ++once) {\n"
                     "    const unsigned g = blockIdx.x * (blockDim.x >> 5) "
                     "+ warp;\n"),
        ("  const int grid = fetch_grid<lane_kernel<W, ANY>>(n, smem, warps * "
         "kLane);\n",
         "  const int grid = ((n - 1) / kLane + warps) / warps;\n")],
    "pop through the parent's meta": [
        ("  int buf = 0, sp = 0;\n", "  int buf = 0, sp = 0, cur = 0;\n"),
        ("          stack[sp + __popc(rest & after)] = meta[lane] >> 4;",
         "          stack[sp + __popc(rest & after)] = (cur << 4) | lane;"),
        ("        next = stack[--sp];  // every lane reads the same word",
         "        const int e = stack[--sp];\n"
         "        next = __ldg(tb.cm + (size_t)(e >> 4) * W + (e & 15)) >> 4;"),
        ("    buf ^= 1;\n    stage.land(sh, buf, lane);",
         "    cur = next;\n    buf ^= 1;\n    stage.land(sh, buf, lane);")],
    # the plain walk's stack form: one (node, untaken children) entry a
    # level, lane 0 writes it, a pop reads the child's id from the node's meta
    "node-mask stack": [
        ("  int buf = 0, sp = 0;\n", "  int buf = 0, sp = 0, cur = 0;\n"),
        ("""        if (lane < W && ((rest >> lane) & 1u)) {
          const unsigned after = rev ? (1u << lane) - 1u : ~0u << (lane + 1);
          stack[sp + __popc(rest & after)] = meta[lane] >> 4;
        }
        sp += __popc(rest);
        next = meta[first] >> 4;
      } else if (sp > 0) {
        next = stack[--sp];  // every lane reads the same word
      }""", """        if (rest) {
          if (lane == 0) {
            stack[2 * sp] = cur;
            stack[2 * sp + 1] = (int)(rest | rev << 16);
          }
          ++sp;
        }
        next = meta[first] >> 4;
      } else if (sp > 0) {
        const int parent = stack[2 * sp - 2];
        const unsigned e = (unsigned)stack[2 * sp - 1];
        const unsigned left = e & 0xffffu, rv = e >> 16;
        const int c = pick(left, rv);
        next = __ldg(tb.cm + (size_t)parent * W + c) >> 4;
        __syncwarp();  // every lane has read the entry
        if (left & (left - 1u)) {
          if (lane == 0)
            stack[2 * sp - 1] = (int)((left & ~(1u << c)) | rv << 16);
        } else {
          --sp;
        }
      }"""),
        ("    buf ^= 1;\n    stage.land(sh, buf, lane);",
         "    cur = next;\n    buf ^= 1;\n    stage.land(sh, buf, lane);")],
    "unstaged leaves": [
        ("      stage_rows<W>(sh, chunk, meta, tb.lt, lane);\n", ""),
        ("leaf_any_s(sh.leaf[k], meta[c] & 15,",
         f"leaf_any_v<4>({_LANE_ROW}, meta[c] & 15,"),
        ("leaf_closest_s(sh.leaf[k], meta[c] & 15,",
         f"leaf_closest_v<4>({_LANE_ROW}, meta[c] & 15,")],
}


def sources(kernels: str) -> dict:
    """``{file name: text}`` of the kernel source and the walk header a
    variant of ``kernels`` ("persist", "two-level", "packet" or "lane")
    patches."""
    from rtjax_torch.kernels import _build
    src, header = {
        "persist": (_build.PERSIST_SOURCE, _build.FETCH_HEADER),
        "two-level": (_build.WIDE_INST_SOURCE, _build.FETCH_HEADER),
        "packet": (_build.PACKET_SOURCE, _build.PACKET_HEADER),
        "lane": (_build.PACKET_SOURCE, _build.LANE_HEADER)}[kernels]
    return {p.name: p.read_text() for p in (src, header)}


def patched(files: dict, edits) -> dict:
    """``files`` (``{name: text}``) with each ``(old, new)`` of ``edits``
    replaced; raises unless each ``old`` occurs exactly once in them."""
    files = dict(files)
    for old, new in edits:
        count = sum(text.count(old) for text in files.values())
        if count != 1:
            raise ValueError(f"{old!r} occurs {count} times in the kernel "
                             "source and header, not once")
        where = next(n for n, text in files.items() if old in text)
        files[where] = files[where].replace(old, new)
    return files


def build(kernels, name, edits):
    from rtjax_torch.kernels import _build
    tag = "".join(c if c.isalnum() else "_" for c in f"{kernels}_{name}")
    out_dir = _build.BUILD_DIR / "variants" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    files = patched(sources(kernels), edits)
    for fname, text in files.items():
        (out_dir / fname).write_text(text)
    src = next(out_dir / f for f in files if f.endswith(".cu"))
    out = out_dir / "lib.so"
    cmd = [_build.nvcc_path()] + _build.NVCC_FLAGS + [
        "-I", str(_build.CSRC_DIR), "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: {' '.join(cmd)}\n{res.stdout}"
                           f"{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    return out


def _persist_calls(cs, torch, args):
    """``({label: (closest args, any-hit args)}, wrappers)`` of the
    persist kernels' ray sets."""
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.render.wavefront import render_frame
    scene, camera = cs.phase2_scene()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sets = {"phase 3": cs._test_rays(scene, camera, gen)}
    captured, restore = cs._capture_launch(cs.CAPTURE_AT)
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                       num_samples=cs.SPP, max_bounces=cs.BOUNCES)
    render_frame(scene, camera, cfg,
                 torch.Generator(device="cuda").manual_seed(1))
    restore()
    sets["in-frame"] = (captured["closest"][1], captured["anyhit"][1])
    tables = dict.fromkeys(sets, scene.tables)
    if args.config4:
        c4, baked, c4_camera = cs.phase5_scene()
        gen = torch.Generator(device="cuda").manual_seed(5678)
        sets["config4 baked"] = cs._field_rays(baked, c4_camera, gen)
        tables["config4 baked"] = baked.tables
        cl, ah = cs._field_rays(c4, c4_camera, gen)
        sets["config4 blas"] = (cs._instance_frame(c4.instances, cl),
                                cs._instance_frame(c4.instances, ah))
        tables["config4 blas"] = c4.blas[0].tables
    calls = {}
    for label, (cl, ah) in sets.items():
        tab = tables[label]
        calls[label] = ((tab, cl["o"], cl["d"], cl["tmax"], cl["active"]),
                        (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
                         ah["active"]))
    return calls, dict(
        module=P, closest=P.persist_traverse_closest,
        anyhit=P.persist_traverse_anyhit,
        closest_ref=P.persist_traverse_closest_ref,
        anyhit_ref=P.persist_traverse_anyhit_ref,
        closest_stride=P.persist_traverse_closest_stride,
        anyhit_stride=P.persist_traverse_anyhit_stride)


def _inst_calls(cs, torch, args):
    """The same for the two-level kernels."""
    import dataclasses

    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import wide_inst as WI
    from rtjax_torch.render.wavefront import render_frame
    from rtjax_torch.scenes import instanced_bunnies
    c4, camera = instanced_bunnies("cuda")
    many, many_camera = instanced_bunnies("cuda", n_inst=cs.MANY_INST)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    sets = {"field": (c4.inst_tables, cs._field_rays(c4, camera, gen)),
            f"{cs.MANY_INST} instances": (
                many.inst_tables, cs._field_rays(many, many_camera, gen))}
    captured, restore = cs._capture_launch(cs.C4_CAPTURE_AT, cs.INST_NAMES)
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                       num_samples=cs.C4_SPP, max_bounces=cs.C4_BOUNCES)
    render_frame(c4, camera, dataclasses.replace(cfg, two_level="kernel"),
                 torch.Generator(device="cuda").manual_seed(2))
    restore()
    sets["in-frame"] = (c4.inst_tables, (captured["closest"][1],
                                         captured["anyhit"][1]))
    calls = {}
    for label, (it, (cl, ah)) in sets.items():
        calls[label] = ((it, cl["o"], cl["d"], cl["tmax"], cl["active"]),
                        (it, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
                         ah["active"]))
    return calls, dict(
        module=WI, closest=WI.wide_traverse_closest_inst,
        anyhit=WI.wide_traverse_anyhit_inst,
        closest_ref=WI.wide_traverse_closest_inst_ref,
        anyhit_ref=WI.wide_traverse_anyhit_inst_ref,
        closest_stride=WI.wide_traverse_closest_inst_stride,
        anyhit_stride=WI.wide_traverse_anyhit_inst_stride)


def _packet_calls(cs, torch, args, walker="packet"):
    """The same for the packet kernels: phase 3's rays, the rays of launch
    ``chip_smoke.CAPTURE_AT`` of a ``walker`` headline frame, and with
    ``--config4`` config 4's baked tables and BLAS."""
    import dataclasses

    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import wide as WD
    from rtjax_torch.render.wavefront import render_frame
    scene, camera = cs.phase2_scene()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sets = {"phase 3": cs._test_rays(scene, camera, gen)}
    captured, restore = cs._capture_launch(cs.CAPTURE_AT,
                                           cs.WALKER_NAMES[walker])
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                       num_samples=cs.SPP, max_bounces=cs.BOUNCES)
    render_frame(scene, camera, dataclasses.replace(cfg, **cs.WALKERS[
        walker]), torch.Generator(device="cuda").manual_seed(2))
    restore()
    sets["in-frame"] = (captured["closest"][1], captured["anyhit"][1])
    tables = dict.fromkeys(sets, scene.tables)
    if args.config4:
        c4, baked, c4_camera = cs.phase5_scene()
        gen = torch.Generator(device="cuda").manual_seed(5678)
        sets["config4 baked"] = cs._field_rays(baked, c4_camera, gen)
        tables["config4 baked"] = baked.tables
        cl, ah = cs._field_rays(c4, c4_camera, gen)
        sets["config4 blas"] = (cs._instance_frame(c4.instances, cl),
                                cs._instance_frame(c4.instances, ah))
        tables["config4 blas"] = c4.blas[0].tables
    calls = {}
    for label, (cl, ah) in sets.items():
        tab = tables[label]
        calls[label] = ((tab, cl["o"], cl["d"], cl["tmax"], cl["active"]),
                        (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
                         ah["active"]))

    def closest_ref(*a):
        return WD.group_traverse_closest_ref(*a, WD.PACKET)

    def anyhit_ref(*a):
        return WD.group_traverse_anyhit_ref(*a, WD.PACKET)

    return calls, dict(
        module=WD, closest=WD.wide_traverse_closest,
        anyhit=WD.wide_traverse_anyhit, closest_ref=closest_ref,
        anyhit_ref=anyhit_ref,
        closest_stride=WD.wide_traverse_closest_leader,
        anyhit_stride=WD.wide_traverse_anyhit_leader)


def _lane_calls(cs, torch, args):
    """The same for the lane kernels: phase 3's rays, the rays of launch
    ``chip_smoke.CAPTURE_AT`` of a ``walker="lane"`` headline frame (its
    lane closest-hit and persist any-hit launches), and with ``--config4``
    config 4's baked tables and BLAS."""
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import wide as WD
    calls, _ = _packet_calls(cs, torch, args, "lane")

    def closest_ref(*a):
        return WD.group_traverse_closest_ref(*a, L.LANE)

    def anyhit_ref(*a):
        return WD.group_traverse_anyhit_ref(*a, L.LANE)

    return calls, dict(
        module=WD, closest=L.lane_traverse_closest,
        anyhit=L.lane_traverse_anyhit, closest_ref=closest_ref,
        anyhit_ref=anyhit_ref, closest_stride=L.lane_traverse_closest_group,
        anyhit_stride=L.lane_traverse_anyhit_group)


def _flat(out):
    """A closest-hit result as a flat tuple of tensors."""
    return tuple(c for o in out for c in (o if isinstance(o, tuple)
                                          else (o,)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels",
                    choices=("persist", "two-level", "packet", "lane"),
                    default="persist")
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--config4", action="store_true",
                    help="persist, packet and lane: also time config 4's "
                         "baked tables and BLAS")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    table = {"persist": VARIANTS, "two-level": INST_VARIANTS,
             "packet": PACKET_VARIANTS, "lane": LANE_VARIANTS}[args.kernels]
    names = [v for v in args.only.split(",") if v] or list(table)

    import torch

    import chip_smoke as cs
    from rtjax_torch.kernels import _build
    from rtjax_torch.kernels import wide as WD

    card = cs.phase0_device()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda n: build(args.kernels, n, table[n]), names)))
    for name, lib in libs.items():
        for kernel, res in _build.ptxas_report(lib):
            label = cs._group_label(kernel) \
                if args.kernels in ("packet", "lane") \
                else cs._kernel_label(kernel)
            if "fetch" in kernel or label.startswith(f"{args.kernels} "):
                print(f"[ptxas {name}] {label}: {res}")

    calls, k = {"persist": _persist_calls, "two-level": _inst_calls,
                "packet": _packet_calls, "lane": _lane_calls}[args.kernels](
        cs, torch, args)
    mod = k["module"]
    shipped = WD.PACKET

    def use(name):
        """Load variant ``name``'s library (and, for the packet kernels,
        its packet size): the wrappers then launch it."""
        mod._lib = bound[name]
        if args.kernels == "packet":
            WD.PACKET = PACKET_GROUPS.get(name, shipped)

    wants = {}
    bound = {n: mod.bind(ctypes.CDLL(str(lib))) for n, lib in libs.items()}
    for name in bound:
        use(name)
        for label, (cargs, aargs) in calls.items():
            key = label, WD.PACKET
            if key not in wants:
                wants[key] = (_flat(k["closest_ref"](*cargs)),
                              k["anyhit_ref"](*aargs))
            got = _flat(k["closest"](*cargs))
            occ = k["anyhit"](*aargs)
            torch.cuda.synchronize()
            want_c, want_a = wants[key]
            if not all(torch.equal(a, b) for a, b in zip(got, want_c)) \
                    or not torch.equal(occ, want_a):
                raise RuntimeError(f"{name} disagrees with the plain "
                                   f"versions on the {label} rays")
    print(f"[variants {args.kernels}] every variant bit-identical to the "
          f"plain versions on {', '.join(calls)}")

    first = {"packet": "leader design", "lane": "group design"}.get(
        args.kernels, "stride design")
    rows = [*bound, first]
    times = {(n, label, kind): [] for n in rows for label in calls
             for kind in ("closest", "anyhit")}
    for _ in range(args.rounds):
        for name in rows:
            old = name == first
            if not old:
                use(name)
            closest = k["closest_stride" if old else "closest"]
            anyhit = k["anyhit_stride" if old else "anyhit"]
            for label, (cargs, aargs) in calls.items():
                times[name, label, "closest"].append(
                    cs._launch_ms(lambda: closest(*cargs)))
                times[name, label, "anyhit"].append(
                    cs._launch_ms(lambda: anyhit(*aargs)))
    WD.PACKET = shipped
    for name in rows:
        print(f"[variants {args.kernels}] {card}: {name}: " + "; ".join(
            f"{label} {kind} " + " / ".join(
                f"{m:.4f} ({lo:.4f}-{hi:.4f})"
                for m, lo, hi in times[name, label, kind]) + " ms"
            for label in calls for kind in ("closest", "anyhit"))
            + f" (device time per launch: mean (least-most) of {cs.REPS} "
            f"launches, {args.rounds} rounds in turns)")


if __name__ == "__main__":
    main()
