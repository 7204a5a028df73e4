"""The TPU probes' counterparts: the wrappers of the hand-written CUDA probe
kernels (``csrc/probes.cu``, loop bodies in ``csrc/probes.cuh``) and their
plain PyTorch versions.

rtjax times its kernels' primitives on the TPU with Pallas probes
(benchmarks/micro_kernel.py, benchmarks/stage_bench.py): one core loops n
times over a [16, 128] tile (2,048 lanes) and writes one int32 checksum,
and the two-point slope over n and 4n iterations gives a primitive's cost.
The port's probes compute the same checksums:

- :func:`nop_copy` / :func:`tile_sum` / :func:`nop_launch`
  (stage_bench.py:123 ``nop_launch``: a copy of a [16, 128] f32 tile in
  one launch, then its sum);
- :func:`scalar_walk` (micro_kernel.py:106 ``make_scalar_walk``: a chain
  of node-meta loads, stack pushes and pops over a [1024] int32 table);
- :func:`tile_probe` (micro_kernel.py:59 ``_smem_out_call``, launching
  the slab steps ``_make_slab_step`` / ``_row1`` / ``_fused`` and the leaf
  Möller–Trumbore steps ``make_leaf_mt_vpu`` / ``_nodiv``; by the names of
  :data:`TILE_VARIANTS`, micro_kernel.py's ``ALL``);
- :func:`clz` (micro_kernel.py:777 ``make_clz``);
- :func:`mxu_probe` (the tensor-core leaf tests, micro_kernel.py:387
  ``make_leaf_mt_mxu``, :457 ``_full``, :529 ``_pair``, :602 ``_group``;
  by the names of :data:`MXU_VARIANTS`; csrc/mxu_probes.cuh on
  ``mma.sync``).

Each takes the JAX probe's operands in its layout (the table ``[1024,
128]`` f32, the rays ``[7 or 6, 16, 128]`` f32, the meta ``[1024]``
int32) and returns ``[tiles]`` int32, one checksum a tile (a chain for the
two scalar probes); every tile computes the same one, which
:func:`checksum` checks.  The tensor-core probes take their A table and F
as rtjax builds them (:data:`MXU`) and return ``[tiles, 2048]`` f32, each
ray's best t (11h: t + f32(prim) * 1e-9), every tile the same
(:func:`same_tiles`).  ``tiles=1`` is the TPU probe's one core (one
block, or one thread for a chain); :func:`full_card` gives the tiles that
fill the card (every SM times its resident blocks, times the block's
threads for a chain).

A CUDA tensor goes to the kernels (built at first use, bound with
ctypes, launched on torch's current stream); a CPU tensor to the plain
versions (``*_ref``), which compute one tile and repeat it.  There is no
fallback between them.  Integer sums wrap modulo 2^32, as JAX's int32
sums do.  The tensor-core probes' plain versions round as their kernels
do (one TF32 pass, 3xTF32 or bf16: :func:`mxu_products`) and sum each
mma's products in k order from zero, mma after mma; the tensor cores sum
in their own order, so on the card the two agree bit for bit where every
sum is exact (small integers, ``probes.micro_kernel.exact_operands``).

Counts: ``LAUNCHES[name]`` one a kernel launch, ``REF_CALLS[name]`` one a
plain call.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from . import _build

TILE_LANES = 2048     # the TPU tile, [16, 128]
TILE_THREADS = 256    # a tile's block: 8 lanes a thread
ROWS = 1024           # the table, [1024, 128] f32
ROW_LANES = 128
STACK = 64            # the scalar walk's SMEM stack
PID_BASE = 96         # a leaf row's prim ids at lanes 96..103
BIG = 3.4e38

# the tile probes: micro_kernel.py's name -> csrc/probes.cuh ``Variant``
TILE_VARIANTS = {"slab_pair": 0, "slab_wide4": 1, "slab_wide8": 2,
                 "slab_wide8_row1": 3, "slab_wide8_fused": 4,
                 "slab_wide16_fused": 5, "leaf_mt_vpu": 6,
                 "leaf_mt_vpu_nodiv": 7, "leaf_mt_vpu_row1": 8,
                 "leaf_mt_vpu_par": 9}
# (children, fused accept) of a slab probe; the mode of a leaf probe
SLAB = {"slab_pair": (2, False), "slab_wide4": (4, False),
        "slab_wide8": (8, False), "slab_wide8_row1": (8, False),
        "slab_wide8_fused": (8, True), "slab_wide16_fused": (16, True)}
LEAF = {"leaf_mt_vpu": "serial", "leaf_mt_vpu_nodiv": "nodiv",
        "leaf_mt_vpu_row1": "serial", "leaf_mt_vpu_par": "parallel"}


@dataclass(frozen=True)
class MxuSpec:
    """A tensor-core probe (csrc/mxu_probes.cuh ``Mxu<V>``): rows of a
    field (slots), fields, the product's depth K, A blocks in the table,
    the precision ("bf16", "tf32" or "tf32x3"), the accept ("recip" 11e,
    "winner" 11f, "pair" 11g, "group" 11h) and rtjax's table shape."""
    slots: int
    fields: int
    k: int
    blocks: int
    prec: str
    accept: str
    table: tuple

    @property
    def rows(self) -> int:
        return self.slots * self.fields

    @property
    def dtype(self):
        return torch.bfloat16 if self.prec == "bf16" else torch.float32

    @property
    def out_fields(self) -> int:
        """Rows of a tile's fields: t; t, prim; or t, u, v, prim, nx, ny,
        nz."""
        return {"recip": 1, "group": 2}.get(self.accept, 7)

    @property
    def leaves(self) -> int:
        """Leaves of 8 triangles an iteration visits."""
        return self.slots // 8 if self.accept == "group" else \
            2 if self.accept == "pair" else 1

    @property
    def macs(self) -> int:
        """The tensor cores' multiply-adds a tile iteration (3xTF32: three
        products)."""
        return self.rows * self.k * TILE_LANES * (
            3 if self.prec == "tf32x3" else 1)


MXU_PASSES = 16   # chunk passes a warp makes a tile iteration (kMxuPasses)

# micro_kernel.py's tensor-core names -> csrc/mxu_probes.cuh MxuVariant;
# _pair_unpacked's [112, 16] blocks are the packed [14, 128] blocks'
# bytes, so one kernel serves _pair and _pair_unpacked
MXU_VARIANTS = {"leaf_mt_mxu_f32": 0, "leaf_mt_mxu_bf16": 1,
                "leaf_mt_mxu_full": 2, "leaf_mt_mxu_full_hi": 3,
                "leaf_mt_mxu_pair": 4, "leaf_mt_mxu_pair_hi": 5,
                "leaf_mt_mxu_pair_unpacked": 4, "leaf_mt_mxu_g8_splitk": 6,
                "leaf_mt_mxu_g4_splitk": 7, "leaf_mt_mxu_g2_splitk": 8,
                "leaf_mt_mxu_g8_f32": 9}
MXU = {
    "leaf_mt_mxu_f32": MxuSpec(8, 4, 16, 512, "tf32", "recip",
                               (512 * 32, 16)),
    "leaf_mt_mxu_bf16": MxuSpec(8, 4, 16, 512, "bf16", "recip",
                                (512 * 32, 16)),
    "leaf_mt_mxu_full": MxuSpec(8, 8, 16, 512, "tf32", "winner",
                                (512 * 64, 16)),
    "leaf_mt_mxu_full_hi": MxuSpec(8, 8, 16, 512, "tf32x3", "winner",
                                   (512 * 64, 16)),
    "leaf_mt_mxu_pair": MxuSpec(16, 7, 16, 512, "tf32", "pair",
                                (512 * 14, 128)),
    "leaf_mt_mxu_pair_hi": MxuSpec(16, 7, 16, 512, "tf32x3", "pair",
                                   (512 * 14, 128)),
    "leaf_mt_mxu_pair_unpacked": MxuSpec(16, 7, 16, 512, "tf32", "pair",
                                         (512 * 112, 16)),
    "leaf_mt_mxu_g8_splitk": MxuSpec(64, 4, 96, 128, "bf16", "group",
                                     (128 * 256, 96)),
    "leaf_mt_mxu_g4_splitk": MxuSpec(32, 4, 96, 128, "bf16", "group",
                                     (128 * 128, 96)),
    "leaf_mt_mxu_g2_splitk": MxuSpec(16, 4, 96, 128, "bf16", "group",
                                     (128 * 64, 96)),
    "leaf_mt_mxu_g8_f32": MxuSpec(64, 4, 16, 128, "tf32", "group",
                                  (128 * 256, 16)),
}

# kernel ids of ``rtjax_probe_kernel_info``
KERNEL_IDS = {"nop_copy": 0, "nop_copy_pdl": 1, "tile_sum": 2,
              "scalar_walk": 3, "clz": 4,
              **{k: 16 + v for k, v in TILE_VARIANTS.items()},
              **{k: 32 + v for k, v in MXU_VARIANTS.items()}}

NAMES = ("nop_copy", "tile_sum", "scalar_walk", *TILE_VARIANTS, "clz",
         *MXU_VARIANTS)
LAUNCHES = {k: 0 for k in NAMES}
REF_CALLS = {k: 0 for k in NAMES}

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_lock = threading.Lock()
_lib = None


def bind(lib):
    """Set the argument types of a probe library's entry points
    (``ctypes.CDLL``) and return it."""
    lib.rtjax_probe_copy.argtypes = [_P, _P, _I32, _I32, _P]
    lib.rtjax_probe_sum.argtypes = [_P, _P, _I32, _P]
    lib.rtjax_probe_scalar_walk.argtypes = [_P, _P, _I32, _I32, _P]
    lib.rtjax_probe_clz.argtypes = [_P, _I32, _I32, _P]
    lib.rtjax_probe_tile.argtypes = [_I32, _P, _P, _P, _I32, _I32, _P]
    lib.rtjax_probe_mxu.argtypes = [_I32, _P, _P, _P, _P, _I32, _I32, _P]
    lib.rtjax_probe_kernel_info.argtypes = ([_I32]
                                            + [ctypes.POINTER(_I32)] * 4)
    for f in (lib.rtjax_probe_copy, lib.rtjax_probe_sum,
              lib.rtjax_probe_scalar_walk, lib.rtjax_probe_clz,
              lib.rtjax_probe_tile, lib.rtjax_probe_mxu,
              lib.rtjax_probe_kernel_info):
        f.restype = _I32
    return lib


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(_build.probes_library())))
        return _lib


def _on_card(t) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    version); other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"probe {name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _tiles_of(x, name="x"):
    """The tiles of a ``[16, 128]`` or ``[T, 16, 128]`` f32 tensor."""
    tiles = 1 if x.dim() == 2 else x.shape[0]
    _check(x, name, torch.float32,
           (16, 128) if x.dim() == 2 else (tiles, 16, 128))
    if tiles < 1:
        raise ValueError(f"{name} holds no tile")
    return tiles


def _positive(n, what):
    if int(n) != n or n < 1:
        raise ValueError(f"{what} must be a positive int, got {n}")
    return int(n)


def _iterations(n):
    if int(n) != n or not 0 <= n < 2 ** 31:
        raise ValueError(f"n must be an int in [0, 2^31), got {n}")
    return int(n)


def _int32(acc: torch.Tensor) -> torch.Tensor:
    """An int64 sum as the int32 it wraps to (modulo 2^32)."""
    return (torch.remainder(acc + 2 ** 31, 2 ** 32) - 2 ** 31).to(
        torch.int32)


def _repeat(one: torch.Tensor, tiles: int) -> torch.Tensor:
    return one.reshape(1).expand(tiles).contiguous()


def checksum(out: torch.Tensor) -> int:
    """The checksum of a probe's ``[tiles]`` output, every tile equal (a
    tile that differs raises)."""
    vals = out.cpu()
    if not bool((vals == vals[0]).all()):
        bad = int((vals != vals[0]).sum())
        raise AssertionError(f"{bad} of {vals.numel()} tiles differ from "
                             f"tile 0's checksum {vals[0].item()}")
    return int(vals[0])


# ------------------------------------------------------------ no-op launch
def nop_copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`nop_copy`."""
    REF_CALLS["nop_copy"] += 1
    return x.clone()


def nop_copy(x: torch.Tensor, out: torch.Tensor | None = None,
             pdl: bool = False) -> torch.Tensor:
    """stage_bench.py:116-117's ``nop_kernel``: ``x`` (``[16, 128]`` or
    ``[T, 16, 128]`` f32) copied into ``out`` (same shape; made when None),
    one block a tile; ``pdl``: launched as a programmatic dependent of the
    kernel before it."""
    tiles = _tiles_of(x)
    if not _on_card(x):
        copy = nop_copy_ref(x)
        return copy if out is None else out.copy_(copy)
    if out is None:
        out = torch.empty_like(x)
    if out.device != x.device:
        raise ValueError("out must be on x's device")
    _tiles_of(out, "out")
    if out.shape != x.shape:
        raise ValueError("out must have x's shape")
    _launched("nop_copy", _kernels().rtjax_probe_copy(
        x.data_ptr(), out.data_ptr(), tiles, int(bool(pdl)),
        _stream(x.device)))
    return out


def tile_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`tile_sum`."""
    REF_CALLS["tile_sum"] += 1
    return x.reshape(-1, TILE_LANES).sum(1)


def tile_sum(x: torch.Tensor) -> torch.Tensor:
    """``[T]`` f32: each tile of ``x`` summed (the ``jnp.sum`` of
    stage_bench.py's ``nop_launch``), one block a tile."""
    tiles = _tiles_of(x)
    if not _on_card(x):
        return tile_sum_ref(x)
    out = torch.empty(tiles, dtype=torch.float32, device=x.device)
    _launched("tile_sum", _kernels().rtjax_probe_sum(
        x.data_ptr(), out.data_ptr(), tiles, _stream(x.device)))
    return out


def nop_launch(x: torch.Tensor) -> torch.Tensor:
    """stage_bench.py:121-128's ``nop_launch``: the copy's sum, ``[T]``."""
    return tile_sum(nop_copy(x))


# ------------------------------------------------------------ scalar walk
def scalar_walk_ref(meta: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`scalar_walk`, one chain (``[1]`` int32)."""
    REF_CALLS["scalar_walk"] += 1
    dev, i32 = meta.device, torch.int32
    stack = torch.full((STACK,), -2 ** 31, dtype=i32, device=dev)
    cur = torch.zeros((), dtype=i32, device=dev)
    sp = torch.ones((), dtype=i32, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n):
        m = meta[cur]
        leaf = (m & 15) > 0
        nxt = torch.remainder(m >> 4, ROWS)
        stack[torch.remainder(sp, STACK)] = cur
        sp = torch.where(leaf, sp + 1, torch.clamp_min(sp - 1, 0))
        # the reference interpreter clamps a pop past the stack's end
        popped = stack[torch.clamp(sp - 1, 0, STACK - 1)]
        cur = torch.where(leaf, nxt, torch.remainder(popped, ROWS))
        acc = acc + m
    return _int32(acc).reshape(1)


def scalar_walk(meta: torch.Tensor, n: int, chains: int = 1
                ) -> torch.Tensor:
    """micro_kernel.py:87-113's walk of ``n`` steps over ``meta``
    (``[1024]`` int32): ``[chains]`` int32, one checksum a chain."""
    _check(meta, "meta", torch.int32, (ROWS,))
    n, chains = _iterations(n), _positive(chains, "chains")
    if not _on_card(meta):
        return _repeat(scalar_walk_ref(meta, n), chains)
    out = torch.empty(chains, dtype=torch.int32, device=meta.device)
    _launched("scalar_walk", _kernels().rtjax_probe_scalar_walk(
        meta.data_ptr(), out.data_ptr(), n, chains, _stream(meta.device)))
    return out


# -------------------------------------------------------------------- clz
def _msb(v: torch.Tensor) -> torch.Tensor:
    """31 - clz(v) of positive int64 values below 2^31."""
    return sum(((v >> b) > 0).to(torch.int64) for b in range(1, 31))


def clz_ref(n: int, device="cpu") -> torch.Tensor:
    """Plain version of :func:`clz` (``[1]`` int32); its iterations are
    independent, so it takes them all at once."""
    REF_CALLS["clz"] += 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    x = ((i * 40503) & 255).clamp_min(1)
    return _int32((_msb(x & -x) + _msb(x)).sum()).reshape(1)


def clz(n: int, chains: int = 1, device="cuda") -> torch.Tensor:
    """micro_kernel.py:763-782's loop of ``n`` iterations: ``[chains]``
    int32, one checksum a chain."""
    n, chains = _iterations(n), _positive(chains, "chains")
    device = torch.device(device)
    if not _on_card(torch.empty(0, device=device)):
        return _repeat(clz_ref(n, device), chains)
    out = torch.empty(chains, dtype=torch.int32, device=device)
    _launched("clz", _kernels().rtjax_probe_clz(out.data_ptr(), n, chains,
                                                _stream(device)))
    return out


# ------------------------------------------------------------ tile probes
def _slab_hits(b, inv, sc, tmax, fused):
    e0 = b[0] * inv[0] + sc[0]
    e1 = b[1] * inv[1] + sc[1]
    e2 = b[2] * inv[2] + sc[2]
    x0 = b[3] * inv[0] + sc[0]
    x1 = b[4] * inv[1] + sc[1]
    x2 = b[5] * inv[2] + sc[2]
    ent = torch.maximum(torch.maximum(torch.minimum(e0, x0),
                                      torch.minimum(e1, x1)),
                        torch.minimum(e2, x2))
    ext = torch.minimum(torch.minimum(torch.maximum(e0, x0),
                                      torch.maximum(e1, x1)),
                        torch.maximum(e2, x2))
    if fused:
        return torch.maximum(ent, ent.new_zeros(())) <= \
            torch.minimum(ext, tmax)
    return (ent <= ext) & (ext >= 0.0) & (ent <= tmax)


def child_weights(children: int, fused: bool) -> list[int]:
    """What each child's hit adds to a lane's checksum (micro_kernel.py
    :132-140 two children as ``hits[0] * 16384 + hits[-1]``, more as bytes
    ``m0`` and ``m1``; the fused steps, :219-224, pairs ``hits[2j] * 32768
    + hits[2j + 1]``)."""
    if fused:
        pairs = (children + 7) // 8 * 4
        return [0 if c >= 2 * pairs else 1 if c % 2 else 32768
                for c in range(children)]
    if children <= 2:
        return [(16384 if c == 0 else 0) + (1 if c == children - 1 else 0)
                for c in range(children)]
    return [1 << (8 * (c if c < 4 else c - 4)) for c in range(children)]


def _slab_ref(table, rays, n, children, fused):
    r = rays.reshape(7, TILE_LANES)
    inv, sc, tmax = r[0:3], r[3:6], r[6]
    w = child_weights(children, fused)
    acc = torch.zeros((), dtype=torch.int64, device=rays.device)
    for i in range(n):
        row = table[i % ROWS]
        s = torch.zeros(TILE_LANES, dtype=torch.int64, device=rays.device)
        for c in range(children):
            hit = _slab_hits(row[6 * c:6 * c + 6], inv, sc, tmax, fused)
            s = s + hit.to(torch.int64) * w[c]
        acc = acc + s.sum()
    return _int32(acc)


def _leaf_lanes(table, rays, n, mode):
    """Each lane's prim after n leaf visits."""
    r = rays.reshape(6, TILE_LANES)
    o, d = r[0:3], r[3:6]
    dev, f32 = rays.device, torch.float32
    tmax = torch.full((TILE_LANES,), BIG, dtype=f32, device=dev)
    t = tmax.clone()
    prim = torch.full((TILE_LANES,), -1, dtype=torch.int32, device=dev)
    for i in range(n):
        row = table[i % ROWS]
        ref_tmax = tmax
        if mode == "nodiv":
            bat = torch.full_like(tmax, BIG)
            badet = torch.ones_like(tmax)
            bprim = torch.full_like(prim, -1)
        for slot in range(8):
            (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz) = \
                row[12 * slot:12 * slot + 12]
            pid = row[PID_BASE + slot].to(torch.int32)
            cx, cy, cz = p0x - o[0], p0y - o[1], p0z - o[2]
            rx = d[1] * cz - d[2] * cy
            ry = d[2] * cx - d[0] * cz
            rz = d[0] * cy - d[1] * cx
            det = d[0] * nx + d[1] * ny + d[2] * nz
            if mode == "nodiv":
                s = torch.where(det < 0.0, -1.0, 1.0).to(f32)
                adet = det * s
                au = (e2x * rx + e2y * ry + e2z * rz) * s
                av = (e1x * rx + e1y * ry + e1z * rz) * s
                at = (cx * nx + cy * ny + cz * nz) * s
                h = (au >= 0.0) & (av >= 0.0) & (au + av <= adet) & \
                    (at > 0.0) & (at <= tmax * adet)
                closer = h & (at * badet < bat * adet)
                bat = torch.where(closer, at, bat)
                badet = torch.where(closer, adet, badet)
                bprim = torch.where(closer, pid, bprim)
                continue
            inv_det = torch.reciprocal(det)
            u = inv_det * (e2x * rx + e2y * ry + e2z * rz)
            v = inv_det * (e1x * rx + e1y * ry + e1z * rz)
            tt = inv_det * (cx * nx + cy * ny + cz * nz)
            cmp = tmax if mode == "serial" else ref_tmax
            h = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > 0.0) & \
                (tt <= cmp)
            tmax = torch.where(h & (tt < tmax), tt, tmax)
            t = torch.where(h & (tt <= t), tt, t)
            prim = torch.where(h & (tt <= t), pid, prim)   # the new t
        if mode == "nodiv":
            ok = bprim >= 0
            bt = bat / badet   # one division a visit
            tmax = torch.where(ok, bt, tmax)
            t = torch.where(ok, bt, t)
            prim = torch.where(ok, bprim, prim)
    return prim


def ray_rows(name: str) -> int:
    """Rows of a tile probe's rays: 7 (inv, sc, tmax) for a slab probe, 6
    (o, d) for a leaf probe."""
    return 7 if name in SLAB else 6


def tile_probe_ref(name: str, table: torch.Tensor, rays: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Plain version of :func:`tile_probe`, one tile (``[1]`` int32)."""
    REF_CALLS[name] += 1
    if name in SLAB:
        return _slab_ref(table, rays, n, *SLAB[name]).reshape(1)
    prim = _leaf_lanes(table, rays, n, LEAF[name])
    return _int32(prim.to(torch.int64).sum()).reshape(1)


def tile_probe(name: str, table: torch.Tensor, rays: torch.Tensor, n: int,
               tiles: int = 1) -> torch.Tensor:
    """Tile probe ``name`` (:data:`TILE_VARIANTS`) of ``n`` iterations
    over ``table`` (``[1024, 128]`` f32, row ``i % 1024`` at iteration i)
    and ``rays`` (``[ray_rows(name), 16, 128]`` f32): ``[tiles]`` int32,
    one checksum a tile."""
    if name not in TILE_VARIANTS:
        raise ValueError(f"unknown tile probe {name!r}")
    _check(table, "table", torch.float32, (ROWS, ROW_LANES))
    _check(rays, "rays", torch.float32, (ray_rows(name), 16, 128))
    if rays.device != table.device:
        raise ValueError("rays must be on the table's device")
    n, tiles = _iterations(n), _positive(tiles, "tiles")
    if not _on_card(table):
        return _repeat(tile_probe_ref(name, table, rays, n), tiles)
    out = torch.empty(tiles, dtype=torch.int32, device=table.device)
    _launched(name, _kernels().rtjax_probe_tile(
        TILE_VARIANTS[name], table.data_ptr(), rays.data_ptr(),
        out.data_ptr(), n, tiles, _stream(table.device)))
    return out


# ------------------------------------------------------ tensor-core probes
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of an f32 tensor: 10 mantissa bits, nearest,
    ties away from zero (the bit pattern plus half of its 13 dropped bits,
    then the 13 cleared), NaN as the canonical NaN."""
    bits = x.contiguous().view(torch.int32)
    r = torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), r)


def mxu_products(spec: MxuSpec, a: torch.Tensor):
    """The operand parts of one A (``[rows, K]`` or F ``[K, 2048]``) as its
    kernel rounds them: ``[x]`` in f32 (bf16 operands, exact), ``[rna(x)]``
    (TF32) or ``[big, small]`` (3xTF32)."""
    x = a.float()
    if spec.prec == "bf16":
        return [x]
    big = _tf32(x)
    return [big] if spec.prec == "tf32" else [big, _tf32(x - big)]


def _mxu_product(spec, a_parts, f_parts):
    """A · F as the kernel issues it: each k-step (16 deep in bf16, 8 in
    TF32) one mma, three for 3xTF32 (big·small, small·big, big·big), each
    mma's products added to the sum in k order, from zero."""
    step = 16 if spec.prec == "bf16" else 8
    order = [(0, 1), (1, 0), (0, 0)] if spec.prec == "tf32x3" else [(0, 0)]
    out = a_parts[0].new_zeros(spec.rows, TILE_LANES)
    for k0 in range(0, spec.k, step):
        for ia, ib in order:
            a, f = a_parts[ia], f_parts[ib]
            for k in range(k0, k0 + step):
                out += a[:, k, None] * f[k]
    return out


def _mxu_lanes(name, table, feats, n):
    """Each ray's fields after n iterations of probe ``name``'s plain
    version: ``[out_fields, 2048]`` f32 (t first)."""
    spec = MXU[name]
    dev, f32 = feats.device, torch.float32
    blocks = table.reshape(spec.blocks, spec.rows, spec.k)
    f_parts = mxu_products(spec, feats)
    S = spec.slots
    best_t = torch.full((TILE_LANES,), BIG, dtype=f32, device=dev)
    rest = [torch.full_like(best_t, BIG), torch.full_like(best_t, BIG),
            torch.full_like(best_t, -1.0), torch.zeros_like(best_t),
            torch.zeros_like(best_t), torch.zeros_like(best_t)]
    best_p = torch.full((TILE_LANES,), -1, dtype=torch.int32, device=dev)
    for i in range(n):
        b = i % spec.blocks
        out = _mxu_product(spec, mxu_products(spec, blocks[b]), f_parts)
        if spec.accept == "recip":   # micro_kernel.py:371-383
            det, un, vn, tn = out[0:8], out[8:16], out[16:24], out[24:32]
            inv_det = torch.reciprocal(det)
            u, v, t = un * inv_det, vn * inv_det, tn * inv_det
            h = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & \
                (t < best_t)
            best_t = torch.minimum(best_t, torch.where(h, t, BIG).amin(0))
            continue
        det, tn, un, vn = (out[f * S:(f + 1) * S] for f in range(4))
        s = torch.where(det < 0.0, -1.0, 1.0)
        adet, at_, au, av = det * s, tn * s, un * s, vn * s
        h = (au >= 0.0) & (av >= 0.0) & (au + av <= adet) & (at_ > 0.0) & \
            (at_ <= best_t * adet)
        t_rows = torch.where(h, at_ / adet, BIG)
        visit_t = t_rows.amin(0)
        improved = visit_t < best_t
        if spec.accept == "group":   # :578-590, the first row at the min
            rows = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
            slot = torch.where(t_rows <= visit_t, rows, S).amin(0)
            best_p = torch.where(improved, b * S + slot, best_p)
            best_t = torch.where(improved, visit_t, best_t)
            continue
        slot = torch.argmin(t_rows, 0)   # :434-446, :506-516
        take = lambda r: r.gather(0, slot[None])[0]   # noqa: E731
        wdet = take(det)
        if spec.accept == "pair":
            pid = torch.tensor(float(b) * 8.0, dtype=f32, device=dev) + \
                slot.to(f32)
            normals = out[4 * S:7 * S]
        else:
            pid = take(out[4 * S:5 * S])
            normals = out[5 * S:8 * S]
        new = [take(un) / wdet, take(vn) / wdet, pid,
               *(take(normals[f * S:(f + 1) * S]) for f in range(3))]
        rest = [torch.where(improved, x, r) for x, r in zip(new, rest)]
        best_t = torch.where(improved, visit_t, best_t)
    if spec.accept == "recip":
        return best_t[None]
    if spec.accept == "group":
        return torch.stack([best_t, best_p.to(f32)])
    return torch.stack([best_t, *rest])


def mxu_out(name: str, fields: torch.Tensor) -> torch.Tensor:
    """A tile's out from its fields (``[..., out_fields, 2048]``): the best
    t, for 11h t + f32(prim) * 1e-9 (micro_kernel.py:601)."""
    t = fields[..., 0, :]
    if MXU[name].accept != "group":
        return t.clone()
    nano = torch.tensor(1e-9, dtype=torch.float32, device=fields.device)
    return t + fields[..., 1, :] * nano


def mxu_probe_ref(name: str, table: torch.Tensor, feats: torch.Tensor,
                  n: int):
    """Plain version of :func:`mxu_probe`, one tile: ``(out [1, 2048],
    fields [1, out_fields, 2048])``."""
    REF_CALLS[name] += 1
    fields = _mxu_lanes(name, table, feats, n)[None]
    return mxu_out(name, fields), fields


def mxu_probe(name: str, table: torch.Tensor, feats: torch.Tensor, n: int,
              tiles: int = 1, fields: bool = False):
    """Tensor-core probe ``name`` (:data:`MXU_VARIANTS`) of ``n``
    iterations over ``table`` (rtjax's A blocks, :data:`MXU` ``table``,
    block ``i % blocks`` at iteration i) and ``feats`` (F, ``[K, 2048]``),
    bf16 or f32 as rtjax's probe: ``[tiles, 2048]`` f32, every tile the
    same; with ``fields`` also each tile's ``[out_fields, 2048]``."""
    if name not in MXU:
        raise ValueError(f"unknown tensor-core probe {name!r}")
    spec = MXU[name]
    _check(table, "table", spec.dtype, spec.table)
    _check(feats, "feats", spec.dtype, (spec.k, TILE_LANES))
    if feats.device != table.device:
        raise ValueError("feats must be on the table's device")
    n, tiles = _iterations(n), _positive(tiles, "tiles")
    if not _on_card(table):
        out, fl = mxu_probe_ref(name, table, feats, n)
        out = out.expand(tiles, -1).contiguous()
        fl = fl.expand(tiles, -1, -1).contiguous()
        return (out, fl) if fields else out
    dev = table.device
    out = torch.empty(tiles, TILE_LANES, dtype=torch.float32, device=dev)
    fl = torch.empty(tiles, spec.out_fields, TILE_LANES, dtype=torch.float32,
                     device=dev) if fields else None
    _launched(name, _kernels().rtjax_probe_mxu(
        MXU_VARIANTS[name], table.data_ptr(), feats.data_ptr(),
        out.data_ptr(), None if fl is None else fl.data_ptr(), n, tiles,
        _stream(dev)))
    return (out, fl) if fields else out


def same_tiles(out: torch.Tensor) -> torch.Tensor:
    """Tile 0 of a tensor-core probe's ``[tiles, ...]`` f32 output, every
    tile equal to it bit for bit (a tile that differs raises)."""
    bits = out.contiguous().view(torch.int32).cpu()
    bad = (bits != bits[0]).reshape(bits.shape[0], -1).any(1)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} of {bits.shape[0]} tiles "
                             "differ from tile 0")
    return out[0]


# ------------------------------------------------------------ launch shape
def kernel_info(name) -> dict:
    """A probe kernel's registers, local (spill) bytes a thread, threads a
    block and resident blocks an SM at that block, by :data:`KERNEL_IDS`
    name."""
    vals = [_I32() for _ in range(4)]
    rc = _kernels().rtjax_probe_kernel_info(KERNEL_IDS[name],
                                            *map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"probe kernel info of {name} failed: CUDA "
                           f"error {rc}")
    regs, local, block, blocks = (v.value for v in vals)
    return dict(registers=regs, local_bytes=local, block=block,
                blocks_per_sm=blocks, warps_per_sm=blocks * -(-block // 32))


def full_card(name, device="cuda") -> int:
    """The tiles (chains for the scalar walk and clz) that fill the card:
    every SM times the kernel's resident blocks (times its threads for a
    chain)."""
    info = kernel_info(name)
    sms = torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count
    per_block = info["block"] if name in ("scalar_walk", "clz") else 1
    return sms * info["blocks_per_sm"] * per_block
