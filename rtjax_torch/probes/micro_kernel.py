"""Microbenchmarks of the walk's primitives on the card: the Hopper
counterparts of rtjax's TPU probes (benchmarks/micro_kernel.py).

Each probe is a kernel that loops n times over one 2,048-lane tile
(kernels/probes.py, csrc/probes.cu); every number is a two-point slope:
the same probe at n and 4n in-kernel iterations, (t_4n - t_n) / 3n, each
time the device time of a launch between CUDA events (launches queued
behind a spin kernel, :func:`rtjax_torch.probes.launch_ms`).  A probe is
timed at two grid sizes: one tile (one block, one thread for the scalar
walk and clz: a step's latency and issue cost on one SM) and the full
card (every SM times its resident blocks, each computing the same tile:
the card's rate).  Cycles are at the card's maximum SM clock
(``nvidia-smi --query-gpu=clocks.max.sm``); the bound is the probe
kernel's iteration, a warp's instructions in the SASS's loop body
(:func:`rtjax_torch.probes.loop_instructions`), over 4 warp-instructions
a clock on an SM.

The tensor-core leaf tests (``leaf_mt_mxu_*``, csrc/mxu_probes.cuh on
``mma.sync``) run f32 operands as one TF32 pass (rtjax's default
precision) or 3xTF32 (``precision="highest"``: ``_full_hi``,
``_pair_hi``), bf16 operands as one bf16 pass; their bound is the larger
of the tensor cores' (the multiply-adds over one SM's share of the dense
peak) and the issue of their iteration's instructions, and their line
also gives ns a leaf visit of 8 triangles (ns over the 1, 2 or G leaves
an iteration tests), to set beside ``leaf_mt_vpu``'s.

Usage: python -m rtjax_torch.probes.micro_kernel [names...] [--scale S]

``ALL`` holds rtjax's probe names with its iteration counts (``--scale``
multiplies them); a name of rtjax's ``ALL`` that is not ported yet exits
with the ROADMAP item that holds it.
"""

from __future__ import annotations

import argparse
import re
import sys
from functools import partial

import numpy as np
import torch

from . import card, issue_bound_cycles, launch_ms, library_sass, \
    loop_instructions, mma_loop_instructions, need_card, slope_ns
from ..kernels import _build
from ..kernels import probes as PK

REPS = 3   # timed launches at each of a slope's two counts


def make_scalar_walk(n_iters, tiles=1, device="cuda"):
    """The scalar walk on rtjax's probe's table, ``arange(1024)`` (its
    chain stays at node 0)."""
    meta = torch.arange(1024, dtype=torch.int32, device=device)
    return (lambda m: PK.scalar_walk(m, n_iters, tiles)), (meta,)


def _make_tile(n_iters, tiles=1, device="cuda", name=None):
    """A tile probe on rtjax's probe's kind of operands: a [1024, 128]
    table and the rays, uniform in [0, 1) (seeded here)."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.random((1024, 128), np.float32)).to(device)
    rays = torch.from_numpy(rng.random((PK.ray_rows(name), 16, 128),
                                       np.float32)).to(device)
    return (lambda t, r: PK.tile_probe(name, t, r, n_iters, tiles)), \
        (table, rays)


def make_clz(n_iters, tiles=1, device="cuda"):
    return (lambda: PK.clz(n_iters, tiles, device)), ()


def _mxu_tensor(x: np.ndarray, name: str, device="cuda") -> torch.Tensor:
    """A tensor-core probe's operand as rtjax types it (bf16 or f32)."""
    return torch.from_numpy(np.array(x, np.float32)).to(
        device=device, dtype=PK.MXU[name].dtype)


def _make_mxu(n_iters, tiles=1, device="cuda", name=None):
    """A tensor-core probe on rtjax's probe's kind of operands: the A table
    and F uniform in [0, 1) (seeded here), in rtjax's shapes and types."""
    spec = PK.MXU[name]
    rng = np.random.default_rng(0)
    table = _mxu_tensor(rng.random(spec.table), name, device)
    feats = _mxu_tensor(rng.random((spec.k, PK.TILE_LANES)), name, device)
    return (lambda a, f: PK.mxu_probe(name, a, f, n_iters, tiles)), \
        (table, feats)


# exact_operands' feature rows of a ray (K = 16): d, o x d, o, the 1, and
# three pairs of equal rows whose A columns cancel (x - x), placed so that
# each pair spans the two TF32 k-steps or one bf16 pair
FEAT_D, FEAT_OD, FEAT_O, FEAT_ONE = (0, 1, 2), (4, 5, 6), (8, 9, 10), 12
FEAT_PAIRS = ((3, 11), (7, 13), (14, 15))
EXACT_MAX = 240   # |A| entries (bf16 holds every integer up to 256)


def _triangles(rng, count):
    """``count`` non-degenerate triangles of integer vertices in [-3, 3]
    whose rows' entries stay within EXACT_MAX: (p0, e1, e2, n)."""
    got = []
    while sum(len(g[0]) for g in got) < count:
        p = rng.integers(-3, 4, (4 * count, 3, 3)).astype(np.float64)
        p0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        n = np.cross(e1, e2)
        big = np.maximum.reduce([np.abs(np.cross(e2, e1)).max(1),
                                 np.abs(np.cross(p0, e2)).max(1),
                                 np.abs(np.cross(p0, e1)).max(1),
                                 np.abs(n).max(1),
                                 np.abs((p0 * n).sum(1))])
        ok = (np.abs(n).max(1) > 0) & (big <= EXACT_MAX)
        got.append((p0[ok], e1[ok], e2[ok], n[ok]))
    return tuple(np.concatenate([g[k] for g in got])[:count]
                 for k in range(4))


def exact_operands(name: str, rng) -> list:
    """Numpy operands of tensor-core probe ``name`` (rtjax's shapes; bf16
    probes take them as bf16, exactly) whose products are exact in bf16,
    TF32 and f32, in any order: real triangles and rays of small integer
    coordinates (vertices in [-3, 3], origins in [-3, 3]^2 x [-9, -3],
    directions in [-3, 3]^2 x [1, 3]).  A's rows (rtjax's field order) from
    each triangle, against F's rows (d, o x d, o, 1): det d·(e2 x e1); un
    d·(p0 x e2) + (o x d)·e2; vn -d·(p0 x e1) - (o x d)·e1; tn o·n - p0·n
    (n = e1 x e2); prims and normals from the 1; each row also +c and -c
    on FEAT_PAIRS' equal rows.  |A| <= 240, |F| <= 36 and every sum under
    2^24, so any dropped or misplaced product shows; the split-K probes
    spread each coefficient over their six 16-deep K blocks as small
    integers adding up to it (F the same 16 rows six times)."""
    spec = PK.MXU[name]
    S, L = spec.slots, PK.TILE_LANES
    p0, e1, e2, n = _triangles(rng, spec.blocks * S)
    coef = {"det": [(FEAT_D, np.cross(e2, e1))],
            "un": [(FEAT_D, np.cross(p0, e2)), (FEAT_OD, e2)],
            "vn": [(FEAT_D, -np.cross(p0, e1)), (FEAT_OD, -e1)],
            "tn": [(FEAT_O, n), ((FEAT_ONE,), -(p0 * n).sum(1)[:, None])],
            "pid": [((FEAT_ONE,), rng.integers(0, 241, (len(n), 1)))],
            "nx": [((FEAT_ONE,), n[:, :1])], "ny": [((FEAT_ONE,), n[:, 1:2])],
            "nz": [((FEAT_ONE,), n[:, 2:])]}
    order = {"recip": ("det", "un", "vn", "tn"),
             "winner": ("det", "tn", "un", "vn", "pid", "nx", "ny", "nz"),
             "pair": ("det", "tn", "un", "vn", "nx", "ny", "nz"),
             "group": ("det", "tn", "un", "vn")}[spec.accept]
    a = np.zeros((spec.blocks, len(order), S, 16))
    for f, field in enumerate(order):
        rows = np.zeros((len(n), 16))
        for cols, val in coef[field]:
            rows[:, list(cols)] = val
        for i, j in FEAT_PAIRS:
            c = rng.integers(-3, 4, len(n))
            rows[:, i] += c
            rows[:, j] -= c
        a[:, f] = rows.reshape(spec.blocks, S, 16)
    o = np.concatenate([rng.integers(-3, 4, (2, L)),
                        rng.integers(-9, -2, (1, L))]).astype(np.float64)
    d = np.concatenate([rng.integers(-3, 4, (2, L)),
                        rng.integers(1, 4, (1, L))]).astype(np.float64)
    feats = np.zeros((16, L))
    feats[list(FEAT_D)] = d
    feats[list(FEAT_OD)] = np.cross(o, d, axis=0)
    feats[list(FEAT_O)] = o
    feats[FEAT_ONE] = 1.0
    for i, j in FEAT_PAIRS:
        feats[i] = feats[j] = rng.integers(-3, 4, L)
    if spec.k == 96:
        parts = rng.integers(-2, 3, (5,) + a.shape)
        parts = np.concatenate([parts, (a - parts.sum(0))[None]])
        a = np.moveaxis(parts, 0, -2).reshape(a.shape[:3] + (96,))
        feats = np.tile(feats, (6, 1))
    return [a.reshape(spec.table).astype(np.float32),
            feats.astype(np.float32)]


def deep_meta() -> np.ndarray:
    """A scalar walk's table with a chain of 70 leaf steps (node k -> k +
    1), then interior nodes: the walk pushes past its 64 entries and pops
    from there."""
    meta = np.zeros(1024, np.int32)
    meta[:70] = ((np.arange(70) + 1) << 4) | 1
    meta[70] = 500 << 4
    k = np.arange(71, 1024)
    meta[71:] = ((k * 7 % 1024) << 4) | (k % 3)
    return meta


def mixed_operands(name: str, rng) -> list:
    """Numpy operands of probe ``name`` that show what rtjax's own hide
    (its walk's ``arange(1024)`` stays at node 0, its ids in [0, 1) cast
    to prim 0): the scalar walk's table over the whole int32 range, sign
    bit included (floor modulo); boxes and triangles that some lanes hit
    and others miss, the leaf rows' ids with signs and fractions, |id| in
    [1, 1000) (truncation toward zero); clz has none."""
    if name == "scalar_walk":
        return [rng.integers(-2 ** 31, 2 ** 31, 1024).astype(np.int32)]
    if name == "clz":
        return []
    table = rng.uniform(-1, 1, (1024, 128)).astype(np.float32)
    if name in PK.SLAB:
        lo = rng.uniform(-1.0, 0.2, (1024, 16, 3))
        hi = lo + rng.uniform(0.0, 1.0, (1024, 16, 3))
        table[:, :96] = np.concatenate([lo, hi], -1).reshape(1024, 96)
        rays = np.concatenate([rng.uniform(-3, 3, (3, 16, 128)),
                               rng.uniform(-1, 1, (3, 16, 128)),
                               rng.uniform(0, 2, (1, 16, 128))])
        return [table, rays.astype(np.float32)]
    p0, e1, e2 = (rng.uniform(-1, 1, (1024, 8, 3)) for _ in range(3))
    table[:, :96] = np.concatenate([p0, e1, e2, np.cross(e1, e2)],
                                   -1).reshape(1024, 96)
    mag = rng.integers(1, 1000, (1024, 8)) + rng.uniform(0.0, 0.99,
                                                         (1024, 8))
    table[:, 96:104] = np.where(rng.random((1024, 8)) < 0.5, -mag, mag)
    o = rng.uniform(-0.3, 0.3, (3, 16, 128))
    d = rng.normal(size=(3, 16, 128))
    o[2] -= 3.0
    d[2] = np.abs(d[2]) + 1.0
    return [table, np.concatenate([o, d]).astype(np.float32)]


def launch(name, n, ops, tiles=1, device="cuda"):
    """Probe ``name``'s wrapper on tensor operands ``ops`` (clz takes none
    and runs on ``device``): ``[tiles]`` int32 (a tensor-core probe's
    ``[tiles, 2048]`` f32)."""
    if name in PK.MXU:
        return PK.mxu_probe(name, ops[0], ops[1], n, tiles)
    if name == "scalar_walk":
        return PK.scalar_walk(ops[0], n, tiles)
    if name == "clz":
        return PK.clz(n, tiles, device)
    return PK.tile_probe(name, ops[0], ops[1], n, tiles)


def plain(name, n, ops, device="cuda"):
    """Probe ``name``'s plain version on ``ops`` (clz on ``device``),
    wherever they lie: ``[1]`` int32 (a tensor-core probe's ``[1, 2048]``
    f32)."""
    if name in PK.MXU:
        return PK.mxu_probe_ref(name, ops[0], ops[1], n)[0]
    if name == "scalar_walk":
        return PK.scalar_walk_ref(ops[0], n)
    if name == "clz":
        return PK.clz_ref(n, device)
    return PK.tile_probe_ref(name, ops[0], ops[1], n)


ALL = {
    "scalar_walk": (make_scalar_walk, 200_000),
    "slab_pair": (partial(_make_tile, name="slab_pair"), 30_000),
    "slab_wide4": (partial(_make_tile, name="slab_wide4"), 30_000),
    "slab_wide8": (partial(_make_tile, name="slab_wide8"), 30_000),
    "slab_wide8_row1": (partial(_make_tile, name="slab_wide8_row1"), 30_000),
    "slab_wide8_fused": (partial(_make_tile, name="slab_wide8_fused"),
                         30_000),
    "slab_wide16_fused": (partial(_make_tile, name="slab_wide16_fused"),
                          30_000),
    "leaf_mt_vpu": (partial(_make_tile, name="leaf_mt_vpu"), 20_000),
    "leaf_mt_vpu_nodiv": (partial(_make_tile, name="leaf_mt_vpu_nodiv"),
                          20_000),
    "leaf_mt_vpu_row1": (partial(_make_tile, name="leaf_mt_vpu_row1"),
                         20_000),
    "leaf_mt_vpu_par": (partial(_make_tile, name="leaf_mt_vpu_par"), 20_000),
    "leaf_mt_mxu_f32": (partial(_make_mxu, name="leaf_mt_mxu_f32"), 20_000),
    "leaf_mt_mxu_bf16": (partial(_make_mxu, name="leaf_mt_mxu_bf16"),
                         20_000),
    "leaf_mt_mxu_full": (partial(_make_mxu, name="leaf_mt_mxu_full"),
                         20_000),
    "leaf_mt_mxu_full_hi": (partial(_make_mxu, name="leaf_mt_mxu_full_hi"),
                            20_000),
    "leaf_mt_mxu_pair": (partial(_make_mxu, name="leaf_mt_mxu_pair"),
                         20_000),
    "leaf_mt_mxu_pair_hi": (partial(_make_mxu, name="leaf_mt_mxu_pair_hi"),
                            20_000),
    "leaf_mt_mxu_pair_unpacked": (partial(
        _make_mxu, name="leaf_mt_mxu_pair_unpacked"), 20_000),
    "leaf_mt_mxu_g8_splitk": (partial(_make_mxu,
                                      name="leaf_mt_mxu_g8_splitk"), 10_000),
    "leaf_mt_mxu_g4_splitk": (partial(_make_mxu,
                                      name="leaf_mt_mxu_g4_splitk"), 10_000),
    "leaf_mt_mxu_g2_splitk": (partial(_make_mxu,
                                      name="leaf_mt_mxu_g2_splitk"), 20_000),
    "leaf_mt_mxu_g8_f32": (partial(_make_mxu, name="leaf_mt_mxu_g8_f32"),
                           10_000),
    "clz": (make_clz, 200_000),
}

# rtjax's probes still to port, and where ROADMAP lists them
_QUEUE = "ROADMAP.md Queue B 'Still to port'"
NOT_PORTED = {
    **{k: f"{_QUEUE} item 1 (row 11i, A blocks streamed from memory)"
       for k in ("mxu_hbm_full", "mxu_hbm_nodma", "mxu_hbm_noext",
                 "mxu_hbm_nomm", "mxu_hbm_dmaonly")},
    "feature_build": f"{_QUEUE} item 1 (row 11j, the feature build)",
    "relayout": f"{_QUEUE} item 1 (row 11k, the relayout)",
}

# the dense tensor-core peaks (FLOP/s; NVIDIA's H100 SXM data sheet): a
# tensor-core probe's bound is its multiply-adds over one SM's share
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "tf32x3": 495e12}


def bench_slope(make_fn, n1=20_000, factor=4, tiles=1, device="cuda"):
    """ns an iteration by the two-point slope (a launch's fixed cost
    cancels)."""
    f1, a1 = make_fn(n1, tiles, device)
    f2, a2 = make_fn(n1 * factor, tiles, device)
    t1 = launch_ms(lambda: f1(*a1), REPS)[0]
    t2 = launch_ms(lambda: f2(*a2), REPS)[0]
    return slope_ns(t1, t2, n1, factor)


def _warps(name, tiles_per_sm):
    """Warps an iteration issues on one SM: a tile's 8 (a chain's one
    warp) times the tiles resident there."""
    if name in ("scalar_walk", "clz"):
        return max(1, -(-tiles_per_sm // 32))
    return PK.TILE_THREADS // 32 * tiles_per_sm


def function_of(name: str, functions) -> str:
    """The mangled name of a probe's kernel among a library's
    ``functions``."""
    key = {"scalar_walk": "scalar_walk_kernel", "clz": "clz_kernel"}.get(
        name, f"mxu_kernelILi{PK.MXU_VARIANTS[name]}E" if name in PK.MXU
        else f"tile_kernel(_1block)?ILi{PK.TILE_VARIANTS.get(name)}E")
    hits = [f for f in functions if re.search(key, f)]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels match {name}'s {key}")
    return hits[0]


def mxu_bound_ns(name: str, sms: int, tiles_per_sm: int = 1) -> float:
    """A tensor-core probe's tensor-core bound (ns a tile iteration at
    ``tiles_per_sm`` tiles on each SM): the multiply-adds over one SM's
    share of the dense peak of its precision (3xTF32: three products)."""
    spec = PK.MXU[name]
    return 2 * spec.macs * tiles_per_sm / (PEAK_FLOPS[spec.prec] / sms) * 1e9


def run(names, scale=1.0) -> dict:
    """Each probe of ``names`` at one tile and at the full card:
    ``{name: {n, one_tile, full_card, instructions}}``; a grid's record
    holds its tiles, ns and cycles an iteration and its issue bound.  A
    tensor-core probe's record also holds its HMMA instructions, its
    iteration's instructions a warp (the inner loop's, once a chunk pass:
    csrc/mxu_probes.cuh kMxuPasses), its tensor-core bound and the larger
    of the two bounds, and ns a leaf visit of 8 triangles."""
    info = card()
    sass = library_sass(_build.probes_library())
    instructions = loop_instructions(sass)
    mma_loops = mma_loop_instructions(sass)
    out = {}
    for name in names:
        make_fn, n1 = ALL[name]
        n = max(1, round(n1 * scale))
        mxu = name in PK.MXU
        if mxu:
            loop, hmma = mma_loops[function_of(name, mma_loops)]
            instr = loop * PK.MXU_PASSES
            rec = dict(n=n, instructions=instr, loop_instructions=loop,
                       hmma=hmma, leaves=PK.MXU[name].leaves)
        else:
            instr = instructions[function_of(name, instructions)]
            rec = dict(n=n, instructions=instr)
        for grid in ("one_tile", "full_card"):
            tiles = 1 if grid == "one_tile" else PK.full_card(name)
            per_sm = 1 if grid == "one_tile" else tiles // info["sms"]
            ns = bench_slope(make_fn, n, tiles=tiles)
            bound = issue_bound_cycles(instr, _warps(name, per_sm))
            g = dict(tiles=tiles, tiles_per_sm=per_sm, ns=ns,
                     cycles=ns * info["clock_mhz"] / 1e3,
                     bound_cycles=bound,
                     bound_ns=bound / info["clock_mhz"] * 1e3)
            if mxu:
                g["issue_ns"] = g["bound_ns"]
                g["tensor_ns"] = mxu_bound_ns(name, info["sms"], max(per_sm,
                                                                     1))
                g["bound_ns"] = max(g["issue_ns"], g["tensor_ns"])
                g["bound_by"] = "tensor cores" if \
                    g["tensor_ns"] >= g["issue_ns"] else "issue"
                g["leaf_ns"] = ns / rec["leaves"]
                g["card_leaf_ns"] = ns / rec["leaves"] / tiles
            rec[grid] = g
        out[name] = rec
    return out


def _line(name, rec, clock):
    one, full = rec["one_tile"], rec["full_card"]
    unit = "chains" if name in ("scalar_walk", "clz") else "tiles"
    line = (f"{name}: {one['ns']:8.1f} ns/iter ({one['cycles']:.1f} cycles "
            f"at {clock}; issue bound {one['bound_cycles']:.1f}, "
            f"{rec['instructions']} instructions a warp), full card "
            f"{full['tiles']} {unit}: {full['ns']:.1f} ns/iter "
            f"({full['cycles']:.1f} cycles; issue bound "
            f"{full['bound_cycles']:.1f}); n = {rec['n']}")
    if "hmma" not in rec:
        return line
    return (f"{line}; bound {one['bound_ns']:.1f} ns ({one['bound_by']}: "
            f"tensor cores {one['tensor_ns']:.1f}, issue "
            f"{one['issue_ns']:.1f}), full card {full['bound_ns']:.1f} ns; "
            f"{rec['hmma']} HMMA in a {rec['loop_instructions']}-instruction "
            f"loop body; a leaf visit of 8 triangles {one['leaf_ns']:.1f} ns"
            f" (one tile), {full['card_leaf_ns']:.2f} ns of the card")


def main(argv=None) -> dict:
    """Print ``name: X ns/iter`` lines (one tile, then the full card) and
    return :func:`run`'s records."""
    p = argparse.ArgumentParser(prog="python -m rtjax_torch.probes."
                                "micro_kernel", description=__doc__.split(
                                    "\n\n")[0])
    p.add_argument("names", nargs="*")
    p.add_argument("--scale", type=float, default=1.0,
                   help="multiplies every probe's iteration count")
    args = p.parse_args(argv)
    names = args.names or list(ALL)
    for name in names:
        if name in NOT_PORTED:
            raise SystemExit(f"{name}: not ported to the card yet; "
                             f"{NOT_PORTED[name]}")
        if name not in ALL:
            raise SystemExit(f"{name}: no such probe (names: "
                             f"{', '.join(ALL)})")
    need_card()
    info = card()
    print(f"{info['line']}, {info['clock']} max SM clock, {info['sms']} SMs")
    out = run(names, args.scale)
    for name, rec in out.items():
        print(_line(name, rec, info["clock"]), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
