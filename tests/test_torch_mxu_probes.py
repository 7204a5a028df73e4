"""The tensor-core leaf tests' counterparts (rtjax_torch/kernels/probes.py
``mxu_probe``, csrc/mxu_probes.cuh) against rtjax's probes
(benchmarks/micro_kernel.py ``make_leaf_mt_mxu``, ``_full``, ``_pair``,
``_group``) on the CPU.

rtjax's probes run as tests/test_torch_probes.py runs them: imported from
``benchmarks/`` with their JAX config updates undone, ``pl.pallas_call``
patched to ``interpret=True``, stepped under ``jax.disable_jit()``.

- On ``probes.micro_kernel.exact_operands`` (triangles and rays of small
  integer coordinates: every product exact in bf16, TF32 and f32, in any
  order) each name's plain version gives rtjax's output bit for bit;
  those cases hit on some lanes and miss on others, with winners in
  different slots.
- On rtjax's own operands (``np.random.rand`` after ``np.random.seed``)
  the names whose product is f32-faithful (bf16 operands, products exact;
  3xTF32) match rtjax within ``RTOL``: the two sum their 16-96 products in
  different orders (XLA's dot against the kernel's mma by mma), at most K
  roundings of 2^-24 in each of det and a numerator, K <= 96.  The TF32
  names are held to rtjax on the exact operands, and their rounding
  (``_tf32``) to a numpy round to nearest, ties away, at 10 mantissa bits.
- The device code: tests/probes_host.cpp runs csrc/mxu_probes.cuh's warp
  code as host C++ (a warp's 32 lanes as fibers in step at each shuffle
  and mma, the mma by the PTX ISA's fragment layouts), through the real
  ctypes wrapper; out and every field equal the plain version bit for
  bit at one tile and at two, on exact and on random operands.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax_torch.kernels import probes as PK
from rtjax_torch.probes import micro_kernel as PMK
from test_torch_probes import _host_probes, _import_probe

NAMES = list(PK.MXU)
# the names whose product is f32-faithful: held to rtjax's own operands
FAITHFUL = [k for k, v in PK.MXU.items() if v.prec != "tf32"]
RTOL = 1e-5
N = 5   # iterations a case


@pytest.fixture(scope="module")
def jmk():
    return _import_probe("micro_kernel")


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _jax(jmk, name, n, ops):
    """rtjax's probe ``name`` at n iterations on numpy ``ops`` (cast to its
    operands' types), stepped op by op in interpret mode: [2048] f32."""
    f, args = jmk.ALL[name][0](n)
    with jax.disable_jit():
        out = f(*[jnp.asarray(o, a.dtype) for o, a in zip(ops, args)])
    return np.asarray(out)[0]


def _tensors(name, ops):
    return [PMK._mxu_tensor(o, name, "cpu") for o in ops]


def _plain(name, n, ops):
    """The port's plain version on numpy ``ops``: (out [2048], fields)."""
    out, fields = PK.mxu_probe_ref(name, *_tensors(name, ops), n)
    return out[0].numpy(), fields[0].numpy()


def _exact(name, seed=1):
    return PMK.exact_operands(name, np.random.default_rng(seed))


@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_equal_the_tpu_probes_on_exact_operands(
        jmk, interpret, name):
    """Every name's plain version gives rtjax's output bit for bit where
    every product is exact."""
    ops = _exact(name)
    want = _jax(jmk, name, N, ops)
    got, _ = _plain(name, N, ops)
    assert got.dtype == np.float32 and got.shape == (PK.TILE_LANES,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", FAITHFUL)
def test_faithful_names_match_the_tpu_probes_on_their_operands(
        jmk, interpret, name):
    """On rtjax's own operands (seeded) the f32-faithful names match its
    output within RTOL (summation order); lanes with no hit are BIG in
    both."""
    np.random.seed(26)
    _, args = jmk.ALL[name][0](N)
    ops = [np.asarray(a.astype(jnp.float32)) for a in args]
    want = _jax(jmk, name, N, ops)
    got, _ = _plain(name, N, ops)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.array_equal(got >= PK.BIG, want >= PK.BIG)


def test_exact_operands_hit_miss_and_win_in_different_slots():
    """The exact cases hit on some lanes and miss on others, and the
    winners' prims (a slot of a leaf) differ."""
    for name in NAMES:
        _, fields = _plain(name, N, _exact(name))
        t = fields[0]
        hit = t < PK.BIG
        assert 0.1 < hit.mean() < 0.9, name
        if PK.MXU[name].out_fields > 1:
            prim = fields[3 if PK.MXU[name].out_fields == 7 else 1]
            assert len(np.unique(prim[hit])) > 20, name


def test_exact_operands_are_exact():
    """The exact operands are integers that bf16 holds (|A| <= 240, |F| <=
    36), in rtjax's shapes; the split-K blocks add up to the 16-deep
    coefficients."""
    for name in NAMES:
        spec = PK.MXU[name]
        a, f = _exact(name)
        assert a.shape == spec.table and f.shape == (spec.k, PK.TILE_LANES)
        for x, top in ((a, 240 + 10), (f, 36)):
            assert np.array_equal(x, np.round(x)) and np.abs(x).max() <= top
            t = PMK._mxu_tensor(x, name, "cpu")
            assert np.array_equal(t.float().numpy(), x)
    a, f = _exact("leaf_mt_mxu_g2_splitk", 4)
    assert all(np.array_equal(f[:16], f[16 * b:16 * b + 16])
               for b in range(6))
    assert np.abs(a.reshape(-1, 6, 16).sum(1)).max() <= 240


def _rna_numpy(x):
    """Round f32 ``x`` to 11 significant bits, nearest, ties away from
    zero (normal numbers)."""
    m, e = np.frexp(x.astype(np.float64))
    s = np.ldexp(m, 11)
    r = np.sign(s) * np.floor(np.abs(s) + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``_tf32`` (the TF32 names' operand rounding, cvt.rna.tf32.f32) is
    round to nearest, ties away from zero, to 10 mantissa bits: on random
    normal floats of every sign and scale, and on exact ties."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)
         ).astype(np.float32)
    ties = (np.arange(1, 2001, dtype=np.float32) + 0.5) * 2.0 ** -11
    ties = np.concatenate([ties, -ties, ties * 2.0 ** 40]).astype(np.float32)
    for v in (x, ties):
        got = PK._tf32(torch.from_numpy(v)).numpy()
        assert np.array_equal(got, _rna_numpy(v))
        assert not (got.view(np.int32) & 0x1FFF).any()
    assert PK._tf32(torch.tensor([1.0 + 2 ** -11])).item() == 1.0 + 2 ** -10
    assert PK._tf32(torch.tensor([-(1.0 + 2 ** -11)])).item() == \
        -(1.0 + 2 ** -10)
    big = torch.tensor([float("inf"), float("nan"), 3.4e38])
    r = PK._tf32(big)
    assert r[0] == float("inf") and torch.isnan(r[1]) and r[2] > 3.3e38


def test_3xtf32_parts_hold_the_operand():
    """The 3xTF32 names' two parts: big + small keeps 21 of f32's 24
    bits."""
    x = torch.rand(4096) * 100
    big, small = PK.mxu_products(PK.MXU["leaf_mt_mxu_full_hi"], x)
    assert torch.equal(big, PK._tf32(x))
    assert ((big + small - x).abs() <= x.abs() * 2.0 ** -21).all()


# ------------------------------------------- the device code on the host
@pytest.fixture(scope="module")
def host_lib():
    return _host_probes()


def _host_cases(name):
    return [("exact", _exact(name, 3), 3),
            ("random", [a.float().numpy() for a in
                        PMK._make_mxu(1, 1, "cpu", name)[1]], 2)]


@pytest.mark.parametrize("name", NAMES)
def test_host_compiled_kernels_equal_plain_versions(monkeypatch, host_lib,
                                                    name):
    """The card's warp code, run by the wrapper on the host (32 lanes in
    step, the mma by the PTX ISA's fragments), gives the plain version's
    out and fields bit for bit, at one tile and at two, every tile
    equal."""
    for kind, ops, n in _host_cases(name):
        t = _tensors(name, ops)
        want_out, want_fields = PK.mxu_probe_ref(name, *t, n)
        with monkeypatch.context() as m:
            m.setattr(PK, "_lib", host_lib)
            m.setattr(PK, "_on_card", lambda x: True)
            m.setattr(torch.cuda, "current_stream",
                      lambda dev=None: type("S", (), {"cuda_stream": 0}))
            one = PK.mxu_probe(name, *t, n)
            two, fields = PK.mxu_probe(name, *t, n, tiles=2, fields=True)
        for got in (one, two):
            assert torch.equal(PK.same_tiles(got), want_out[0]), kind
        assert torch.equal(fields, want_fields.expand(2, -1, -1)), kind


def test_host_entry_point_refuses_bad_arguments(host_lib):
    """An unknown variant and bad counts are refused by the host entry
    point as by the card's."""
    out = torch.empty(PK.TILE_LANES)
    assert host_lib.rtjax_probe_mxu(10, None, None, out.data_ptr(), None, 1,
                                    1, None) != 0
    assert host_lib.rtjax_probe_mxu(0, None, None, out.data_ptr(), None, -1,
                                    1, None) != 0


# --------------------------------------------------------- the wrappers
def test_mxu_wrapper_checks_its_inputs():
    spec = PK.MXU["leaf_mt_mxu_bf16"]
    table = torch.zeros(spec.table, dtype=torch.bfloat16)
    feats = torch.zeros(16, PK.TILE_LANES, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown tensor-core probe"):
        PK.mxu_probe("leaf_mt_vpu", table, feats, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        PK.mxu_probe("leaf_mt_mxu_bf16", table.float(), feats, 1)
    with pytest.raises(TypeError, match="float32"):
        PK.mxu_probe("leaf_mt_mxu_f32", table, feats, 1)
    with pytest.raises(ValueError, match="shape"):
        PK.mxu_probe("leaf_mt_mxu_bf16", table[:-1], feats, 1)
    with pytest.raises(ValueError, match="shape"):
        PK.mxu_probe("leaf_mt_mxu_g2_splitk", table, feats, 1)
    with pytest.raises(ValueError, match="n must be"):
        PK.mxu_probe("leaf_mt_mxu_bf16", table, feats, -1)
    with pytest.raises(ValueError, match="tiles must be"):
        PK.mxu_probe("leaf_mt_mxu_bf16", table, feats, 1, tiles=0)
    with pytest.raises(ValueError, match="unsupported device"):
        PK.mxu_probe("leaf_mt_mxu_bf16", table.to("meta"),
                     feats.to("meta"), 1)


def test_same_tiles_requires_every_tile_equal():
    out = torch.rand(3, PK.TILE_LANES)
    out[1:] = out[0]
    assert torch.equal(PK.same_tiles(out), out[0])
    out[2, 7] += 1.0
    with pytest.raises(AssertionError, match="1 of 3 tiles"):
        PK.same_tiles(out)


def test_mxu_counts_launches_and_plain_calls(monkeypatch, host_lib):
    monkeypatch.setattr(PK, "LAUNCHES", dict.fromkeys(PK.NAMES, 0))
    monkeypatch.setattr(PK, "REF_CALLS", dict.fromkeys(PK.NAMES, 0))
    f, ops = PMK._make_mxu(1, 2, "cpu", "leaf_mt_mxu_pair_unpacked")
    f(*ops)
    assert PK.REF_CALLS["leaf_mt_mxu_pair_unpacked"] == 1
    monkeypatch.setattr(PK, "_lib", host_lib)
    monkeypatch.setattr(PK, "_on_card", lambda x: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    f(*ops)
    assert PK.LAUNCHES == {**dict.fromkeys(PK.NAMES, 0),
                           "leaf_mt_mxu_pair_unpacked": 1}


def test_mxu_specs_follow_the_tpu_probes(jmk):
    """Each spec's table and F shapes and types are those rtjax's probe
    builds; the bounds' multiply-adds are rows x K x 2,048 a product."""
    for name, spec in PK.MXU.items():
        _, (a, f) = jmk.ALL[name][0](1)
        assert a.shape == spec.table and f.shape == (spec.k, PK.TILE_LANES)
        want = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        assert spec.dtype == want
    assert PK.MXU["leaf_mt_mxu_bf16"].macs == 32 * 16 * 2048
    assert PK.MXU["leaf_mt_mxu_pair_hi"].macs == 3 * 112 * 16 * 2048
    assert PK.MXU["leaf_mt_mxu_g8_splitk"].macs == 256 * 96 * 2048
    assert PMK.mxu_bound_ns("leaf_mt_mxu_bf16", 132) == pytest.approx(
        279.9, abs=0.1)
    assert PMK.mxu_bound_ns("leaf_mt_mxu_g8_splitk", 132) == pytest.approx(
        13_435.3, abs=0.1)
