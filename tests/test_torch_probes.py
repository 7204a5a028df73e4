"""The TPU probes' counterparts (rtjax_torch/kernels/probes.py,
rtjax_torch/probes/) against rtjax's probes (benchmarks/micro_kernel.py,
benchmarks/stage_bench.py) on the CPU.

rtjax's probes run as its own tests run Pallas on the CPU: the module's
``pl.pallas_call`` patched to ``interpret=True``, the kernel stepped under
``jax.disable_jit()`` (no XLA fusion contracts a multiply and an add
then).  Each ported probe's plain version must give rtjax's int32
checksum bit for bit (the no-op launch: its float sum, exact for the
data here), on the probe's own operands and on seeded operands that hit
and miss: the probe's own hide faults (``arange(1024)`` keeps the scalar
walk at node 0, and ids in [0, 1) cast to prim 0).  The scalar walk's
seeded tables set the sign bit (floor modulo), the leaf rows' ids carry
signs and fractions (truncation toward zero), and one table walks past
the 64-entry stack (the interpreter clamps the pop's index).

The device code: tests/probes_host.cpp compiles csrc/probes.cuh's loop
bodies as host C++ with the library's entry points, bound by
``probes.bind`` and run through the real wrappers on CPU tensors; every
checksum must equal the plain version's at one tile and at several.
"""

import ctypes
import functools
import importlib
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtjax_torch.probes as PR
from rtjax_torch.kernels import _build
from rtjax_torch.kernels import probes as PK
from rtjax_torch.probes import micro_kernel as PMK
from rtjax_torch.probes import stage_bench as PSB

BENCH = _build.REPO_ROOT / "benchmarks"
# the probes of this file (the tensor-core ones are
# tests/test_torch_mxu_probes.py's)
PORTED = [k for k in PMK.ALL if k not in PK.MXU]
N = {"scalar_walk": 8, "clz": 8}   # iterations a JAX case (tile probes 4)


def _import_probe(name):
    """rtjax's probe script ``name``, its JAX config updates undone (the
    scripts set a compilation cache when imported or run)."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    sys.path.insert(0, str(BENCH))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(BENCH))
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.fixture(scope="module")
def jmk():
    return _import_probe("micro_kernel")


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _jax(jmk, name, n, ops=None):
    """rtjax's probe ``name`` at n iterations on ``ops`` (None: its own
    operands), stepped op by op in interpret mode: its int32 checksum and
    the operands."""
    make, _ = jmk.ALL[name]
    f, args = make(n)
    ops = [np.array(a) for a in args] if ops is None else ops
    with jax.disable_jit():
        out = f(*[jnp.asarray(o) for o in ops])
    return int(np.asarray(out)[0]), ops


# ------------------------------------------------------- seeded operands
def _seeded(name, seed=7):
    return PMK.mixed_operands(name, np.random.default_rng(seed))


def _plain(name, n, ops, tiles=1):
    """The port's wrapper on CPU tensors (the plain version, or the
    host-compiled kernels where a test binds them)."""
    t = [torch.from_numpy(np.ascontiguousarray(o)) for o in ops]
    return PMK.launch(name, n, t, tiles, "cpu")


def test_ported_names_are_rtjax_names():
    """The port's ``ALL`` holds rtjax's names letter for letter with its
    iteration counts, and every other name of rtjax's ``ALL`` is listed
    as not ported, with the ROADMAP item that holds it."""
    jmk = _import_probe("micro_kernel")
    assert list(PMK.ALL) == [
        "scalar_walk", "slab_pair", "slab_wide4", "slab_wide8",
        "slab_wide8_row1", "slab_wide8_fused", "slab_wide16_fused",
        "leaf_mt_vpu", "leaf_mt_vpu_nodiv", "leaf_mt_vpu_row1",
        "leaf_mt_vpu_par", "leaf_mt_mxu_f32", "leaf_mt_mxu_bf16",
        "leaf_mt_mxu_full", "leaf_mt_mxu_full_hi", "leaf_mt_mxu_pair",
        "leaf_mt_mxu_pair_hi", "leaf_mt_mxu_pair_unpacked",
        "leaf_mt_mxu_g8_splitk", "leaf_mt_mxu_g4_splitk",
        "leaf_mt_mxu_g2_splitk", "leaf_mt_mxu_g8_f32", "clz"]
    assert {k: v[1] for k, v in PMK.ALL.items()} == \
        {k: jmk.ALL[k][1] for k in PMK.ALL}
    assert set(PMK.ALL) | set(PMK.NOT_PORTED) == set(jmk.ALL)
    assert not set(PMK.ALL) & set(PMK.NOT_PORTED)
    assert all("ROADMAP" in v for v in PMK.NOT_PORTED.values())
    assert set(PK.TILE_VARIANTS) == set(PORTED) - {"scalar_walk", "clz"}
    assert set(PK.MXU_VARIANTS) == set(PK.MXU) == set(PMK.ALL) - set(PORTED)


@pytest.mark.parametrize("data", ["probe", "seeded"])
@pytest.mark.parametrize("name", PORTED)
def test_plain_versions_equal_the_tpu_probes(jmk, interpret, name, data):
    """Each plain version gives rtjax's probe's checksum bit for bit, on
    the probe's own operands and on seeded ones that hit and miss."""
    n = N.get(name, 4) + (data == "seeded")
    want, ops = _jax(jmk, name, n, None if data == "probe" else
                     _seeded(name))
    got = _plain(name, n, ops)
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == want


def test_seeded_operands_hit_and_miss():
    """The seeded tile operands give some lanes a hit and others none: a
    probe's checksum then depends on every lane's test."""
    rng = np.random.default_rng(3)
    for name in ("slab_wide8", "leaf_mt_vpu"):
        table, rays = PMK.mixed_operands(name, rng)
        t, r = torch.from_numpy(table), torch.from_numpy(rays)
        if name == "slab_wide8":
            r = r.reshape(7, -1)
            hits = PK._slab_hits(t[0, :6], r[0:3], r[3:6], r[6], False)
        else:   # one leaf visit: lanes with a prim and lanes without
            hits = PK._leaf_lanes(t, r, 1, "serial") != -1
        assert hits.any() and not hits.all()


def test_scalar_walk_past_its_stack(jmk, interpret):
    """A walk of more than 64 leaf steps pops at an index past the stack,
    which the reference interpreter clamps to entry 63: the plain
    version does the same (a wrapped index gives another checksum)."""
    meta = PMK.deep_meta()
    for n in (72, 90):
        want, _ = _jax(jmk, "scalar_walk", n, [meta])
        assert int(_plain("scalar_walk", n, [meta])[0]) == want


def _jax_nop_launch(monkeypatch, cache_dir):
    """rtjax's ``nop_launch``, local to stage_bench's ``main``: main run
    with ``timeit`` recording what it is given, on a pool of 2^4.  main
    points JAX's compilation cache at ``JAX_CACHE_DIR`` (a fixed path
    when unset), and JAX opens that cache at a process's first compile:
    so it is set to ``cache_dir``."""
    jsb = _import_probe("stage_bench")
    got = {}
    monkeypatch.setenv("JAX_CACHE_DIR", str(cache_dir))
    monkeypatch.setattr(jsb, "timeit",
                        lambda name, f, *a, **k: got.setdefault(name, f))
    monkeypatch.setattr(sys, "argv", ["stage_bench.py", "4"])
    keys = ("jax_compilation_cache_dir",)
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        jsb.main()
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return got["no-op pallas launch"]


def test_nop_launch_equals_the_tpu_probe(monkeypatch, interpret, tmp_path):
    """The no-op launch (copy, then sum) gives rtjax's sum, on its zeros
    and on integer-valued data (exact in any order)."""
    nop = _jax_nop_launch(monkeypatch, tmp_path)
    rng = np.random.default_rng(5)
    for x in (np.zeros((16, 128), np.float32),
              rng.integers(-100, 100, (16, 128)).astype(np.float32)):
        with jax.disable_jit():
            want = float(np.asarray(nop(jnp.asarray(x))))
        t = torch.from_numpy(x)
        assert float(PK.nop_launch(t)[0]) == want
        assert torch.equal(PK.nop_copy(t), t)
    tiles = torch.from_numpy(np.stack([x, x, x]))
    assert PK.nop_launch(tiles).tolist() == [want] * 3


# ------------------------------------------- the device code on the host
def _host_probes():
    """csrc/probes.cuh's loop bodies compiled as host C++ with the
    library's entry points (tests/probes_host.cpp), bound as the probe
    library."""
    src = Path(__file__).with_name("probes_host.cpp")
    out = _build._build(
        _build.BUILD_DIR / "libprobes_host.so", [src],
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{_build.CSRC_DIR}"], (_build.PROBES_HEADER, _build.MXU_HEADER))
    return PK.bind(ctypes.CDLL(str(out)))


@pytest.fixture
def on_host(monkeypatch):
    """The probes' card path on CPU tensors, over the host-compiled
    library."""
    monkeypatch.setattr(PK, "_lib", _host_probes())
    monkeypatch.setattr(PK, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))


def _cases(name):
    """(operands, n) a host case runs: the probe's own kind of data and
    the seeded kinds (the scalar walk's sign bits and its deep chain, the
    leaf ids' signs and fractions)."""
    rng = np.random.default_rng(11)
    if name == "scalar_walk":
        return [([np.arange(1024, dtype=np.int32)], 40),
                (PMK.mixed_operands(name, rng), 37), ([PMK.deep_meta()], 200)]
    if name == "clz":
        return [([], 0), ([], 300), ([], 70_000)]
    own = [rng.random((1024, 128), np.float32),
           rng.random((PK.ray_rows(name), 16, 128), np.float32)]
    return [(own, 3), (PMK.mixed_operands(name, rng), 6)]


@pytest.mark.parametrize("name", PORTED)
def test_host_compiled_kernels_equal_plain_versions(monkeypatch, name):
    """The card's loop bodies, run by the wrapper on the host, give the
    plain version's checksum bit for bit, at one tile and at three, every
    tile equal."""
    for ops, n in _cases(name):
        want = _plain(name, n, ops)
        with monkeypatch.context() as m:
            m.setattr(PK, "_lib", _host_probes())
            m.setattr(PK, "_on_card", lambda t: True)
            m.setattr(torch.cuda, "current_stream",
                      lambda dev=None: type("S", (), {"cuda_stream": 0}))
            one = _plain(name, n, ops)
            three = _plain(name, n, ops, tiles=3)
        assert one.tolist() == want.tolist()
        assert three.tolist() == want.tolist() * 3
        assert PK.checksum(three) == int(want[0])


def test_host_compiled_slab_wraps_the_table(on_host):
    """Past 1,024 iterations a probe reads the table's rows again from row
    0, on the host-compiled kernels as in the plain version."""
    ops = PMK.mixed_operands("slab_pair", np.random.default_rng(2))
    host = _plain("slab_pair", 1030, ops)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(PK, "_on_card", lambda t: False)
        assert host.tolist() == _plain("slab_pair", 1030, ops).tolist()


def test_host_compiled_nop_launch(on_host):
    """The copy and the sum on the host-compiled library, tile by tile."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-50, 50, (3, 16, 128)).astype(
        np.float32))
    assert torch.equal(PK.nop_copy(x), x)
    assert torch.equal(PK.nop_copy(x, pdl=True), x)
    assert PK.nop_launch(x).tolist() == x.reshape(3, -1).sum(1).tolist()


def _exports(path):
    return sorted(set(re.findall(r'extern "C" \w+(?: \w+)? (rtjax_\w+)\(',
                                 path.read_text())))


def test_library_exports_the_entry_points_bind_binds():
    """csrc/probes.cu and its host stand-in export the same entry points,
    which ``probes.bind`` binds; the variant ids are the header's."""
    card = _exports(_build.PROBES_SOURCE)
    host = _exports(Path(__file__).with_name("probes_host.cpp"))
    assert card == host == ["rtjax_probe_clz", "rtjax_probe_copy",
                            "rtjax_probe_kernel_info", "rtjax_probe_mxu",
                            "rtjax_probe_scalar_walk", "rtjax_probe_sum",
                            "rtjax_probe_tile"]
    assert _host_probes().rtjax_probe_tile.restype is ctypes.c_int
    enum = _build.PROBES_HEADER.read_text().split("enum Variant {")[1]
    ids = re.findall(r"^\s*(k\w+)", enum.split("};")[0], re.M)
    assert ids == ["kSlabPair", "kSlabWide4", "kSlabWide8", "kSlabWide8Row1",
                   "kSlabWide8Fused", "kSlabWide16Fused", "kLeafMt",
                   "kLeafMtNodiv", "kLeafMtRow1", "kLeafMtPar", "kVariants"]
    assert list(PK.TILE_VARIANTS.values()) == list(range(len(ids) - 1))


# --------------------------------------------------------- the wrappers
def test_wrapper_checks_its_inputs():
    table = torch.zeros(1024, 128)
    rays = torch.zeros(7, 16, 128)
    with pytest.raises(ValueError, match="unknown tile probe"):
        PK.tile_probe("leaf_mt_mxu_f32", table, rays, 1)
    with pytest.raises(ValueError, match="shape"):
        PK.tile_probe("leaf_mt_vpu", table, rays, 1)   # 6 ray rows
    with pytest.raises(TypeError, match="float32"):
        PK.tile_probe("slab_pair", table.double(), rays, 1)
    with pytest.raises(ValueError, match="contiguous"):
        PK.tile_probe("slab_pair", torch.zeros(128, 1024).t(), rays, 1)
    with pytest.raises(ValueError, match="n must be"):
        PK.tile_probe("slab_pair", table, rays, -1)
    with pytest.raises(ValueError, match="tiles must be"):
        PK.tile_probe("slab_pair", table, rays, 1, tiles=0)
    with pytest.raises(TypeError, match="int32"):
        PK.scalar_walk(torch.zeros(1024, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="aligned"):
        PK.nop_copy(torch.zeros(16 * 128 + 1)[1:].reshape(16, 128))


def test_checksum_requires_every_tile_equal():
    assert PK.checksum(torch.tensor([5, 5, 5], dtype=torch.int32)) == 5
    with pytest.raises(AssertionError, match="1 of 3 tiles"):
        PK.checksum(torch.tensor([5, 6, 5], dtype=torch.int32))


def test_counts_launches_and_plain_calls(monkeypatch):
    """A plain call counts in REF_CALLS, a launch in LAUNCHES."""
    monkeypatch.setattr(PK, "LAUNCHES", dict.fromkeys(PK.NAMES, 0))
    monkeypatch.setattr(PK, "REF_CALLS", dict.fromkeys(PK.NAMES, 0))
    PK.clz(3, 2, "cpu")
    assert PK.REF_CALLS["clz"] == 1 and not any(PK.LAUNCHES.values())
    monkeypatch.setattr(PK, "_lib", _host_probes())
    monkeypatch.setattr(PK, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    PK.clz(3, 2, "cpu")
    PK.nop_launch(torch.zeros(16, 128))
    assert PK.LAUNCHES == {**dict.fromkeys(PK.NAMES, 0), "clz": 1,
                           "nop_copy": 1, "tile_sum": 1}


# ------------------------------------------------------ the entry points
def test_entry_points_refuse_unported_names_and_a_missing_card(monkeypatch):
    """A name rtjax has but the port not yet exits with its ROADMAP item;
    an unknown name exits; with no card the entry points exit."""
    with pytest.raises(SystemExit, match="ROADMAP.md Queue B"):
        PMK.main(["clz", "mxu_hbm_full"])
    with pytest.raises(SystemExit, match="no such probe"):
        PMK.main(["traverse_coherent"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((PMK.main, ["clz"]), (PSB.main, [])):
        with pytest.raises(SystemExit, match="is_available"):
            main(argv)


def test_module_entry_point_exits_nonzero_for_an_unported_name():
    res = subprocess.run([sys.executable, "-m",
                          "rtjax_torch.probes.micro_kernel", "relayout"],
                         cwd=_build.REPO_ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "row 11k" in res.stderr


SASS = """
	code for sm_90a
		Function : _Z11tile_kernelILi2EEvPKfS1_Pji
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ISETP.GE.AND P0, PT, R2, 0x1, PT ;
        /*0030*/              @!P0 BRA 0x100 ;
        /*0040*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0050*/                   FMUL R5, R4, R6 ;
        /*0060*/                   FCHK P1, R5, R7 ;
        /*0070*/              @!P1 BRA 0x90 ;
        /*0080*/                   CALL.REL.NOINC 0x200 ;
        /*0090*/                   FADD R5, R5, R8 ;
        /*00a0*/                   IADD3 R2, R2, 0x1, RZ ;
        /*00b0*/                   ISETP.NE.AND P2, PT, R2, R3, PT ;
        /*00c0*/               @P2 BRA 0x40 ;
        /*0100*/                   EXIT ;
        /*0110*/                   BRA 0x110;
        /*0200*/                   MUFU.RCP R9, R7 ;
        /*0210*/                   RET.REL.NODEC R10 0x0 ;
		Function : clz_kernel_label_style
        /*0000*/                   MOV R0, RZ ;
.L_x_3:
        /*0010*/                   FLO.U32 R4, R2 ;
        /*0020*/                   IADD3 R0, R0, R4, RZ ;
        /*0030*/               @P0 BRA `(.L_x_3) ;
        /*0040*/                   EXIT ;
"""


def test_loop_instructions_read_the_loop_body():
    """A kernel's iteration is the span of its widest backward branch,
    without the blocks that call out of line (a division's slow path);
    labels (``.L_x_N``) and addresses both name branch targets."""
    got = PR.loop_instructions(SASS)
    assert got == {"_Z11tile_kernelILi2EEvPKfS1_Pji": 8,
                   "clz_kernel_label_style": 3}
    assert PMK.function_of("slab_wide8", got) == \
        "_Z11tile_kernelILi2EEvPKfS1_Pji"
    one_block = "_Z18tile_kernel_1blockILi7EEvPKfS1_Pji"
    assert PMK.function_of("leaf_mt_vpu_nodiv", {**got, one_block: 5}) == \
        one_block
    assert PR.issue_bound_cycles(100, 8) == 200.0
    assert PR.issue_bound_cycles(100, 1) == 100.0
    assert PR.slope_ns(1.0, 4.0, 1000) == pytest.approx(1000.0)
