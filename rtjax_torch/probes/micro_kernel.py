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
    loop_instructions, need_card, slope_ns
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
    and runs on ``device``): ``[tiles]`` int32."""
    if name == "scalar_walk":
        return PK.scalar_walk(ops[0], n, tiles)
    if name == "clz":
        return PK.clz(n, tiles, device)
    return PK.tile_probe(name, ops[0], ops[1], n, tiles)


def plain(name, n, ops, device="cuda"):
    """Probe ``name``'s plain version on ``ops`` (clz on ``device``),
    wherever they lie: ``[1]`` int32."""
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
    "clz": (make_clz, 200_000),
}

# rtjax's probes still to port, and where ROADMAP lists them
_QUEUE = "ROADMAP.md Queue B 'Still to port'"
NOT_PORTED = {
    **{k: f"{_QUEUE} item 1 (rows 11e-11h, the tensor-core family)"
       for k in ("leaf_mt_mxu_f32", "leaf_mt_mxu_bf16", "leaf_mt_mxu_full",
                 "leaf_mt_mxu_full_hi", "leaf_mt_mxu_pair",
                 "leaf_mt_mxu_pair_hi", "leaf_mt_mxu_pair_unpacked",
                 "leaf_mt_mxu_g8_splitk", "leaf_mt_mxu_g4_splitk",
                 "leaf_mt_mxu_g2_splitk", "leaf_mt_mxu_g8_f32")},
    **{k: f"{_QUEUE} item 2 (row 11i, A blocks streamed from memory)"
       for k in ("mxu_hbm_full", "mxu_hbm_nodma", "mxu_hbm_noext",
                 "mxu_hbm_nomm", "mxu_hbm_dmaonly")},
    "feature_build": f"{_QUEUE} item 2 (row 11j, the feature build)",
    "relayout": f"{_QUEUE} item 2 (row 11k, the relayout)",
}


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
        name, f"tile_kernel(_1block)?ILi{PK.TILE_VARIANTS.get(name)}E")
    hits = [f for f in functions if re.search(key, f)]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels match {name}'s {key}")
    return hits[0]


def run(names, scale=1.0) -> dict:
    """Each probe of ``names`` at one tile and at the full card:
    ``{name: {n, one_tile, full_card, instructions}}``; a grid's record
    holds its tiles, ns and cycles an iteration and its issue bound."""
    info = card()
    instructions = loop_instructions(library_sass(_build.probes_library()))
    out = {}
    for name in names:
        make_fn, n1 = ALL[name]
        n = max(1, round(n1 * scale))
        instr = instructions[function_of(name, instructions)]
        rec = dict(n=n, instructions=instr)
        for grid in ("one_tile", "full_card"):
            tiles = 1 if grid == "one_tile" else PK.full_card(name)
            per_sm = 1 if grid == "one_tile" else tiles // info["sms"]
            ns = bench_slope(make_fn, n, tiles=tiles)
            bound = issue_bound_cycles(instr, _warps(name, per_sm))
            rec[grid] = dict(tiles=tiles, tiles_per_sm=per_sm, ns=ns,
                             cycles=ns * info["clock_mhz"] / 1e3,
                             bound_cycles=bound,
                             bound_ns=bound / info["clock_mhz"] * 1e3)
        out[name] = rec
    return out


def _line(name, rec, clock):
    one, full = rec["one_tile"], rec["full_card"]
    unit = "chains" if name in ("scalar_walk", "clz") else "tiles"
    return (f"{name}: {one['ns']:8.1f} ns/iter ({one['cycles']:.1f} cycles "
            f"at {clock}; issue bound {one['bound_cycles']:.1f}, "
            f"{rec['instructions']} instructions a warp), full card "
            f"{full['tiles']} {unit}: {full['ns']:.1f} ns/iter "
            f"({full['cycles']:.1f} cycles; issue bound "
            f"{full['bound_cycles']:.1f}); n = {rec['n']}")


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
