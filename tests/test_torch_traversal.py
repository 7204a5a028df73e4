"""rtjax_torch's binary-BVH walk (kernels/traversal.py) vs rtjax's.

- The plain walk against rtjax's ``traverse_closest`` / ``traverse_anyhit``
  on the same binary BVH (random triangle soups built by rtjax with
  ``max_leaf_size`` 1, 4 and None, carried across as arrays): hit, prim and
  occlusion equal, rtjax's ``with_stats`` counts equal; t, u, v and the
  normal at rtol 1e-5 / atol 1e-6.  rtjax runs under ``jax.disable_jit()``,
  but its ``vmap``-ped ``while_loop`` still compiles as one XLA loop, which
  contracts multiply-adds on the CPU (the port rounds every product), so
  t, u and v differ from rtjax's in the last bits.
- Ports of rtjax's tests/test_bvh.py:51-135: against brute force, any hit
  implies closest hit, inactive lanes miss.
- The stack: on a hand-built tree that pushes one entry a level for 40
  levels the port sizes its stack from the depth and finds the hit that
  rtjax's 30-entry stack drops (the launch rules themselves:
  test_torch_binary_launch.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax.accel import build_bvh_np
from rtjax.accel.bvh import BvhArrays as JaxBvh
from rtjax.core.geometry import Triangles as JaxTris
from rtjax.kernels import (anyhit_brute, closest_brute, traverse_anyhit,
                           traverse_closest)

from rtjax_torch.accel.bvh import BvhArrays
from rtjax_torch.core import geometry as G
from rtjax_torch.core.geometry import Triangles
from rtjax_torch.kernels import traversal as T

from conftest import random_triangles
from test_torch_binary_launch import DEEP_T, deep_bvh, down_rays

N_RAYS = 192


def _soup(seed, n, max_leaf):
    """rtjax's build of a random soup, and both packages' BVH and
    leaf-order triangles."""
    rng = np.random.default_rng(seed)
    tris = JaxTris.from_vertices(*random_triangles(rng, n))
    bmin, bmax = (np.asarray(b) for b in tris.bounds())
    res = build_bvh_np(bmin, bmax, np.asarray(tris.center()),
                       max_leaf_size=max_leaf)
    ptris = tris.gather(jnp.asarray(res.perm))
    jbvh = res.to_device()
    return jbvh, ptris, _port_bvh(jbvh), _port_tris(ptris)


def _port_bvh(jbvh):
    return BvhArrays(*(torch.tensor(np.asarray(getattr(jbvh, f)))
                       for f in ("bmin", "bmax", "left_first", "num_prims")),
                     max_depth=jbvh.max_depth)


def _port_tris(ptris):
    return Triangles(*(torch.tensor(np.asarray(getattr(ptris, f)))
                       for f in ("p0", "e1", "e2", "n")))


def _rays(seed, n=N_RAYS, spread=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, rng


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("n_tris, max_leaf", [(96, 1), (200, 4),
                                              (150, None)],
                         ids=["leaf1", "leaf4", "leafNone"])
def test_plain_walk_matches_rtjax(n_tris, max_leaf):
    jbvh, jtris, bvh, tris = _soup(11, n_tris, max_leaf)
    o, d, rng = _rays(5, spread=0.8)
    tmax = np.where(rng.random(N_RAYS) < 0.3, 1.5, np.inf).astype(np.float32)
    active = rng.random(N_RAYS) > 0.1
    stack = T.stack_len(bvh)
    with jax.disable_jit():
        want = traverse_closest(jbvh, jtris, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tmax), jnp.asarray(active),
                                stack_size=stack, with_stats=True)
    calls = T.REF_CALLS["closest"]
    got = T.traverse_closest(bvh, tris, torch.tensor(o), torch.tensor(d),
                             torch.tensor(tmax), torch.tensor(active),
                             with_stats=True)
    assert T.REF_CALLS["closest"] == calls + 1   # a CPU tensor: plain
    hit = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), hit)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert hit.sum() > N_RAYS // 4
    for k, name in ((1, "t"), (2, "u"), (3, "v")):
        w = np.asarray(want[k])
        _close(got[k].numpy()[hit], w[hit], name)
        np.testing.assert_array_equal(got[k].numpy()[~hit], w[~hit])
    _close(got[5].numpy(), np.asarray(want[5]), "normal")
    assert got[5].shape == (N_RAYS, 3)
    assert tuple(int(x) for x in got[6]) == tuple(int(x) for x in want[6])

    exclude = rng.integers(-1, n_tris, N_RAYS).astype(np.int32)
    tm = rng.uniform(0.5, 4.0, N_RAYS).astype(np.float32)
    with jax.disable_jit():
        occ_w, st_w = traverse_anyhit(
            jbvh, jtris, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            jnp.asarray(exclude), jnp.asarray(active), stack_size=stack,
            with_stats=True)
    occ, st = T.traverse_anyhit(bvh, tris, torch.tensor(o), torch.tensor(d),
                                torch.tensor(tm), torch.tensor(exclude),
                                torch.tensor(active), with_stats=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_w))
    assert occ.sum() > 10
    assert tuple(int(x) for x in st) == tuple(int(x) for x in st_w)


def test_component_triples_and_work_count():
    """Triples in give a triple normal out; the plain versions' work count
    agrees with the stats and names what it read."""
    _, _, bvh, tris = _soup(3, 120, 4)
    o, d, rng = _rays(8, 64)
    ov = tuple(torch.tensor(o[:, k]) for k in range(3))
    dv = tuple(torch.tensor(d[:, k]) for k in range(3))
    tmax = torch.full((64,), float("inf"))
    active = torch.ones(64, dtype=torch.bool)
    work = T.new_work()
    *res, nrm, st = T.traverse_closest_ref(bvh, tris, ov, dv, tmax, active,
                                           with_stats=True, work=work)
    assert isinstance(nrm, tuple) and len(nrm) == 3
    full = T.traverse_closest(bvh, tris, torch.tensor(o), torch.tensor(d),
                              tmax, active)
    for a, b in zip(res, full[:5]):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(nrm, -1), full[5])
    assert (int(st[0]), int(st[1])) == (work["steps"], work["leafs"])
    assert work["tri_tests"] >= work["leafs"] > 0
    assert int(work["pair_seen"].sum()) <= work["steps"]
    assert 0 < int(work["tri_seen"].sum()) <= work["tri_tests"]


def test_slab_matches_rtjax():
    from rtjax.core import geometry as JG
    rng = np.random.default_rng(2)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d[:8, 0] = 0.0
    d[8:16, 1] = -0.0
    d[16:24, 2] = 1e-9
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    lo = rng.uniform(-1, 0, (256, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (256, 3)).astype(np.float32)
    col = lambda a: tuple(torch.tensor(a[:, k]) for k in range(3))
    inv, sc, neg = G.ray_slab_precompute(col(d), col(o))
    ok, entry = G.intersect_aabb(inv, sc, neg, col(lo), col(hi))
    with jax.disable_jit():
        jinv, jsc, jneg = JG.ray_slab_precompute(jnp.asarray(d),
                                                 jnp.asarray(o))
        jok, jentry = JG.intersect_aabb(jinv, jsc, jneg, jnp.asarray(lo),
                                        jnp.asarray(hi))
    np.testing.assert_array_equal(torch.stack(inv, 1).numpy(),
                                  np.asarray(jinv))
    np.testing.assert_array_equal(torch.stack(sc, 1).numpy(),
                                  np.asarray(jsc))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(entry.numpy(), np.asarray(jentry))


# ------------------------------------------ ports of tests/test_bvh.py

@pytest.mark.parametrize("n_tris, max_leaf", [(64, None), (64, 4),
                                              (517, 4)])
def test_traversal_matches_brute_force(n_tris, max_leaf):
    jbvh, jtris, bvh, tris = _soup(7, n_tris, max_leaf)
    o, d, _ = _rays(9, 256)
    tmax = np.full(256, np.inf, np.float32)
    active = np.ones(256, bool)
    hb, tb, ub, vb, pb, _ = (np.asarray(a) for a in closest_brute(
        jtris, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(active)))
    ht, tt, ut, vt, pt, _ = (a.numpy() for a in T.traverse_closest(
        bvh, tris, torch.tensor(o), torch.tensor(d), torch.tensor(tmax),
        torch.tensor(active)))
    np.testing.assert_array_equal(hb, ht)
    np.testing.assert_allclose(tb[hb], tt[hb], rtol=1e-5)
    # prims may differ only at an equal t: compare the hit points
    point = lambda p, u, v: (np.asarray(jtris.p0)[p]
                             - u[:, None] * np.asarray(jtris.e1)[p]
                             + v[:, None] * np.asarray(jtris.e2)[p])
    np.testing.assert_allclose(point(pb[hb], ub[hb], vb[hb]),
                               point(pt[hb], ut[hb], vt[hb]), atol=1e-4)


def test_anyhit_matches_brute_force():
    jbvh, jtris, bvh, tris = _soup(7, 128, 4)
    o, d, rng = _rays(10, 256)
    tmax = rng.uniform(0.5, 4.0, 256).astype(np.float32)
    exclude = rng.integers(-1, 128, 256).astype(np.int32)
    active = np.ones(256, bool)
    want = np.asarray(anyhit_brute(jtris, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax), jnp.asarray(exclude),
                                   jnp.asarray(active)))
    got = T.traverse_anyhit(bvh, tris, torch.tensor(o), torch.tensor(d),
                            torch.tensor(tmax), torch.tensor(exclude),
                            torch.tensor(active)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 10


def test_anyhit_implies_closest_hit():
    _, _, bvh, tris = _soup(7, 128, 4)
    o, d, _ = _rays(11, 128)
    args = (torch.tensor(o), torch.tensor(d), torch.full((128,), np.inf))
    active = torch.ones(128, dtype=torch.bool)
    hit = T.traverse_closest(bvh, tris, *args, active)[0]
    occ = T.traverse_anyhit(bvh, tris, *args,
                            torch.full((128,), -1, dtype=torch.int32),
                            active)
    assert torch.equal(hit, occ) and bool(hit.any())


def test_inactive_lanes_return_miss():
    _, _, bvh, tris = _soup(7, 32, 4)
    o = torch.zeros(8, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    hit, t, u, v, prim, nrm = T.traverse_closest(
        bvh, tris, o, d, torch.full((8,), np.inf),
        torch.zeros(8, dtype=torch.bool))
    assert not bool(hit.any()) and bool(torch.isinf(t).all())
    assert not bool(u.any() or v.any() or nrm.any())
    assert bool((prim == -1).all())
    assert not bool(T.traverse_anyhit(
        bvh, tris, o, d, torch.full((8,), np.inf),
        torch.full((8,), -1, dtype=torch.int32),
        torch.zeros(8, dtype=torch.bool)).any())


# ---------------------------------------------------------------- stack

def test_deep_tree_stack_is_sized_from_the_depth():
    """Forty levels each push one entry (test_torch_binary_launch.py's
    tree): the port's stack holds depth + 1 entries and the walk finds the
    hit of level 35; rtjax's own walk with its default 30 entries drops
    the pushes beyond them (``.at[sp].set`` out of range) and misses it."""
    bvh, tris = deep_bvh()
    jbvh = JaxBvh(*(jnp.asarray(getattr(bvh, f).numpy()) for f in
                    ("bmin", "bmax", "left_first", "num_prims")),
                  bvh.max_depth)
    jtris = JaxTris(*(jnp.asarray(getattr(tris, f).numpy())
                      for f in ("p0", "e1", "e2", "n")))
    o, d = down_rays()
    hit, t, _, _, prim, _ = T.traverse_closest(
        bvh, tris, torch.tensor(o), torch.tensor(d), torch.full((4,), np.inf),
        torch.ones(4, dtype=torch.bool), stack_size=30)
    assert bool(hit.all())
    np.testing.assert_allclose(t.numpy(), DEEP_T)
    with jax.disable_jit():
        jhit, jt, *_ = traverse_closest(
            jbvh, jtris, jnp.asarray(o), jnp.asarray(d),
            jnp.full(4, jnp.inf), jnp.ones(4, bool), stack_size=30)
    assert not np.allclose(np.asarray(jt), DEEP_T)
