"""Elementwise rtjax_torch core math vs rtjax on the same random inputs.

rtjax runs op by op (``jax.disable_jit``), so neither side contracts
multiply-adds.  Integer and bool outputs must match exactly, and so must
floats computed without roots or transcendentals.  The rest compare at
rtol 1e-5 (atol 1e-6 where results cross zero): XLA on the CPU computes
sqrt, sin and cos to within an ulp but not correctly rounded (its
``jnp.sqrt`` differs from IEEE sqrt in the last bit on some inputs), and a
few lanes amplify that ulp through cancellation, e.g. ``n + sample`` in
the matte BSDF or a grazing cosine in the light pdf (measured up to 4.4e-6
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax.core import geometry as jgeo
from rtjax.core import rng as jrng
from rtjax.core import sampling as jsamp
from rtjax.render import sorting as jsort
from rtjax.scene import light as jlight
from rtjax.scene import material as jmat

from rtjax_torch.core import geometry, rng, sampling, vec
from rtjax_torch.render import sorting
from rtjax_torch.scene import light, material

N = 4096


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit(rng, n=N):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(d[:, k] for k in range(3))


def _pt(a):
    return tuple(torch.tensor(c) for c in a) if isinstance(a, tuple) \
        else torch.tensor(a)


def _jx(a):
    return tuple(jnp.asarray(c) for c in a) if isinstance(a, tuple) \
        else jnp.asarray(a)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def _cmp(got, want, exact=False):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _cmp(g, w, exact)
        return
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if exact or got.dtype.kind in "biu":
        _eq(got, want)
    else:
        _close(got, want)


def test_offset_ray_origin_and_spawn():
    rng = _rng(1)
    # near-zero coordinates take the fixed-point branch, the rest the ULP
    # nudge; negative coordinates flip the nudge direction
    p = tuple(np.where(rng.random(N) < 0.3, rng.uniform(-0.05, 0.05, N),
                       rng.uniform(-4, 4, N)).astype(np.float32)
              for _ in range(3))
    n = _unit(rng)
    with jax.disable_jit():
        want = jsamp.offset_ray_origin_v3(_jx(p), _jx(n))
        want_s = jgeo.spawn_offset_ray_v3(_jx(p), _jx(n), _jx(n), 0.5)
    _cmp(sampling.offset_ray_origin_v3(_pt(p), _pt(n)), want, exact=True)
    got_s = geometry.spawn_offset_ray_v3(_pt(p), _pt(n), _pt(n), 0.5)
    _cmp(got_s[0], want_s[0], exact=True)
    _cmp(got_s[2], want_s[2], exact=True)


def test_intersect_triangle_and_power_heuristic():
    rng = _rng(2)
    o = tuple(rng.uniform(-1, 1, N).astype(np.float32) for _ in range(3))
    d = _unit(rng)
    p0 = tuple(rng.uniform(-1, 1, N).astype(np.float32) for _ in range(3))
    e1, e2 = (tuple(rng.uniform(-1, 1, N).astype(np.float32)
                    for _ in range(3)) for _ in range(2))
    nv = tuple(np.asarray(c, np.float32) for c in vec.cross(e1, e2))
    tmax = np.float32(1.5)
    with jax.disable_jit():
        want = jgeo.intersect_triangle_v3(_jx(o), _jx(d), tmax, _jx(p0),
                                          _jx(e1), _jx(e2), _jx(nv))
        want_ph = jsamp.power_heuristic(_jx(o[0]), _jx(o[1]))
    got = geometry.intersect_triangle_v3(_pt(o), _pt(d), float(tmax),
                                         _pt(p0), _pt(e1), _pt(e2), _pt(nv))
    _cmp(got[0], want[0])
    assert 0 < int(got[0].sum()) < N
    for g, w in zip(got[1:], want[1:]):
        _cmp(g, w, exact=True)
    _cmp(sampling.power_heuristic(_pt(o[0]), _pt(o[1])), want_ph)


@pytest.mark.parametrize("mtype", [material.MATTE, material.MIRROR,
                                   material.GLASS],
                         ids=["matte", "mirror", "glass"])
def test_bsdf_sample_and_eval(mtype):
    rng = _rng(3 + mtype)
    mt = np.full(N, mtype, np.int32)
    albedo = tuple(rng.uniform(0, 1, N).astype(np.float32) for _ in range(3))
    ior = rng.uniform(1.2, 1.8, N).astype(np.float32)
    wo, n, wi = _unit(rng), _unit(rng), _unit(rng)
    u1, u2, u3 = (rng.random(N).astype(np.float32) for _ in range(3))
    with jax.disable_jit():
        want = jmat.sample_f_v3(_jx(mt), _jx(albedo), _jx(ior), _jx(wo),
                                _jx(n), _jx(u1), _jx(u2), _jx(u3))
        want_g = jmat.get_f_v3(_jx(mt), _jx(albedo), _jx(wo), _jx(wi),
                               _jx(n))
        want_s = jmat.is_specular(_jx(mt))
    got = material.sample_f_v3(_pt(mt), _pt(albedo), _pt(ior), _pt(wo),
                               _pt(n), _pt(u1), _pt(u2), _pt(u3))
    _cmp(got, want)
    _cmp(material.get_f_v3(_pt(mt), _pt(albedo), _pt(wo), _pt(wi), _pt(n)),
         want_g)
    _cmp(material.is_specular(_pt(mt)), want_s)


@pytest.fixture(scope="module")
def lights():
    """One point light and two area lights (emitter triangles)."""
    rng = _rng(7)
    tris = type("T", (), {})()
    for k in ("p0", "e1", "e2"):
        setattr(tris, k, rng.uniform(-1, 1, (5, 3)).astype(np.float32))
    tris.n = np.cross(tris.e1, tris.e2)
    args = ([jlight.POINT_LIGHT, jlight.AREA_LIGHT, jlight.AREA_LIGHT],
            [(0.2, 1.5, -0.3), (0, 0, 0), (0, 0, 0)],
            [(5.0, 4.0, 3.0), (8.0, 8.0, 8.0), (2.0, 1.0, 0.5)], [-1, 1, 3])
    ours = light.LightTable.from_arrays(light.make_light_arrays(*args, tris),
                                        "cpu")
    return ours, jlight.make_light_table(*args, tris)


def test_light_sample_and_pdf(lights):
    ours, theirs = lights
    rng = _rng(8)
    pick = rng.integers(0, 3, N).astype(np.int32)
    p = tuple(rng.uniform(-2, 2, N).astype(np.float32) for _ in range(3))
    wi = _unit(rng)
    u1, u2 = (rng.random(N).astype(np.float32) for _ in range(2))
    for k in light.LIGHT_FIELDS:
        _eq(getattr(ours, k), getattr(theirs, k))
    with jax.disable_jit():
        want = jlight.sample_li_v3(theirs, _jx(pick), _jx(p), _jx(u1),
                                   _jx(u2))
        want_pdf = jlight.pdf_li_v3(theirs, _jx(pick), _jx(p), _jx(wi))
        want_d = jlight.is_delta(_jx(pick))
    _cmp(light.sample_li_v3(ours, _pt(pick), _pt(p), _pt(u1), _pt(u2)), want)
    got_pdf = light.pdf_li_v3(ours, _pt(pick), _pt(p), _pt(wi))
    _cmp(got_pdf, want_pdf)
    assert int((got_pdf > 0).sum()) > 0
    _cmp(light.is_delta(_pt(pick)), want_d)


def test_random_words_to_uniforms():
    words = np.asarray(jrng.bits_block(jax.random.key(3), 0, 5, N))
    with jax.disable_jit():
        want = jrng.u01_pair(jnp.asarray(words[1]))
    w = torch.tensor(words.astype(np.int64))
    _cmp(rng.u01_pair(w[1]), want, exact=True)
    g = torch.Generator().manual_seed(0)
    b = rng.bits_block(g, 5, 1000)
    assert b.shape == (5, 1000) and b.dtype == torch.int64
    assert int(b.min()) >= 0 and int(b.max()) < 1 << 32
    assert int(b.max()) >= 1 << 31  # the full 32-bit range is drawn


@pytest.mark.parametrize("which", ["morton_pos", "morton"])
def test_sort_keys(which):
    rng = _rng(9)
    o = tuple(rng.uniform(-1.5, 1.5, N).astype(np.float32) for _ in range(3))
    d = _unit(rng)
    lo = np.array([-1, -1, -1], np.float32)
    hi = np.array([1, 1, 1], np.float32)
    active = rng.random(N) > 0.2
    ours = {"morton_pos": sorting.ray_sort_keys_pos_v3,
            "morton": sorting.ray_sort_keys_v3}[which]
    theirs = {"morton_pos": jsort.ray_sort_keys_pos_v3,
              "morton": jsort.ray_sort_keys_v3}[which]
    with jax.disable_jit():
        want = theirs(_jx(o), _jx(d), jnp.asarray(lo), jnp.asarray(hi),
                      jnp.asarray(active))
    _cmp(ours(_pt(o), _pt(d), torch.tensor(lo), torch.tensor(hi),
              torch.tensor(active)), want, exact=True)


def test_octahedral_and_rgb9e5_codecs():
    rng = _rng(10)
    n = tuple(rng.standard_normal(N).astype(np.float32) * 3 for _ in range(3))
    n = tuple(np.where(rng.random(N) < 0.05, 0.0, c).astype(np.float32)
              for c in n)
    v = tuple(np.where(rng.random(N) < 0.1, 0.0,
                       rng.lognormal(0, 4, N)).astype(np.float32)
              for _ in range(3))
    v = (np.where(rng.random(N) < 0.02, np.nan, v[0]).astype(np.float32),
         np.where(rng.random(N) < 0.02, -1.0, v[1]).astype(np.float32), v[2])
    with jax.disable_jit():
        w_oct = jsort.oct_encode_v3(_jx(n))
        d_oct = jsort.oct_decode_v3(w_oct)
        w_rgb = jsort.rgb9e5_encode_v3(_jx(v))
        d_rgb = jsort.rgb9e5_decode_v3(w_rgb)
    o_oct = sorting.oct_encode_v3(_pt(n))
    _cmp(o_oct, w_oct, exact=True)
    _cmp(sorting.oct_decode_v3(o_oct), d_oct, exact=True)
    o_rgb = sorting.rgb9e5_encode_v3(_pt(v))
    _cmp(o_rgb, w_rgb, exact=True)
    _cmp(sorting.rgb9e5_decode_v3(o_rgb), d_rgb, exact=True)


def test_sort_pytree_is_stable_on_duplicate_keys():
    rng = _rng(11)
    keys = rng.integers(0, 7, N).astype(np.int32)    # many duplicates
    keys[rng.random(N) < 0.3] = 0x7FFFFFFF
    cols = (np.arange(N, dtype=np.int32),
            (rng.random(N).astype(np.float32), rng.random(N).astype(np.float32),
             rng.random(N).astype(np.float32)))
    got = sorting.sort_pytree_by_key(torch.tensor(keys),
                                     (_pt(cols[0]), _pt(cols[1])))
    want = jsort.sort_pytree_by_key(jnp.asarray(keys),
                                    (_jx(cols[0]), _jx(cols[1])))
    _cmp(got, want, exact=True)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.argsort(keys, kind="stable"))


def test_integer_pow_matches_jax():
    x = torch.tensor(_rng(12).uniform(0, 1, N).astype(np.float32))
    with jax.disable_jit():
        want = jax.lax.integer_pow(jnp.asarray(x.numpy()), 5)
    _cmp(vec.integer_pow(x, 5), want, exact=True)
