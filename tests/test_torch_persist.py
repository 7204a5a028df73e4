"""rtjax_torch persistent-walker traversal vs rtjax.

The plain PyTorch versions (the port's CPU path, and the oracle the CUDA
kernels are held against on the card) are compared here with rtjax's
persistent-walker Pallas kernels in interpret mode and with rtjax's XLA
traversal, on the same tables and rays:

- ``hit`` / ``occluded`` exactly equal;
- ``t`` at rtol 1e-5 / atol 1e-6 on hits: rtjax's jitted code runs with
  XLA's fused multiply-adds on the CPU, the port rounds every product;
- ``prim`` and ``normal`` equal where the closest t is unique (ties at
  equal t may pick another prim, as between rtjax's own walkers);
- inactive lanes carry the contract values (hit 0, t BIG, prim -1,
  normal 0, occluded 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax.kernels import traverse_anyhit, traverse_closest
from rtjax.kernels.pallas_lane_persist import (
    persist_traverse_anyhit as jax_persist_anyhit,
    persist_traverse_closest as jax_persist_closest)

from rtjax_torch.accel.wide import WideTables
from rtjax_torch.kernels import persist as P

from test_pallas_lane import _pack, _rays

N_RAYS = 3 * 2048 + 300


@pytest.fixture(scope="module", params=[
    8, pytest.param(16, marks=pytest.mark.slow)], ids=["w8", "w16"])
def scene(request):
    res, ptris, tables = _pack(width=request.param)
    ours = WideTables.from_arrays(
        {k: np.asarray(getattr(tables, k)) for k in
         ("node_bounds", "child_meta", "node_info", "leaf_tris")},
        width=tables.width, depth=res.max_depth, device="cpu")
    return res, ptris, tables, ours


def _inputs(seed):
    o, d = _rays(N_RAYS, seed=seed)
    rng = np.random.default_rng(5)
    active = rng.random(N_RAYS) > 0.1
    exclude = np.where(rng.random(N_RAYS) > 0.5,
                       rng.integers(0, 300, N_RAYS), -1).astype(np.int32)
    return np.asarray(o), np.asarray(d), active, exclude


def _tt(a):
    return torch.tensor(np.ascontiguousarray(a))


def _unique_t(ptris, o, d, tmax, t_best):
    """Lanes whose closest t is met by exactly one triangle (brute force
    over all triangles in float64)."""
    p0, e1, e2, n = (np.asarray(getattr(ptris, k), np.float64)
                     for k in ("p0", "e1", "e2", "n"))
    c = p0[None] - o[:, None]
    r = np.cross(d[:, None], c)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / np.einsum("rj,tj->rt", d, n)
        u = inv * np.einsum("tj,rtj->rt", e2, r)
        v = inv * np.einsum("tj,rtj->rt", e1, r)
        t = inv * np.einsum("rtj,tj->rt", c, n)
    ok = (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1 + 1e-6) & (t > 0) & \
        (t <= tmax[:, None])
    near = ok & (np.abs(t - t_best[:, None]) <= 1e-5 * np.abs(t_best[:, None]))
    return near.sum(1) <= 1


@pytest.mark.parametrize("tmax_v", [np.inf, 0.7], ids=["inf", "0.7"])
def test_closest_matches_rtjax(scene, tmax_v):
    res, ptris, tables, ours = scene
    o, d, active, _ = _inputs(3)
    tmax = np.full(N_RAYS, tmax_v, np.float32)
    h, t, p, nrm = P.persist_traverse_closest(ours, _tt(o), _tt(d), _tt(tmax),
                                              _tt(active))
    h, t, p, nrm = h.numpy(), t.numpy(), p.numpy(), nrm.numpy()

    hx, tx, _, _, px, nx = (np.asarray(a) for a in traverse_closest(
        res.to_device(), ptris, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), jnp.asarray(active)))
    hp, tp, pp, np_ = (np.asarray(a) for a in jax_persist_closest(
        tables, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(active), interpret=True))
    for want_h, want_t, want_p, want_n in ((hx, tx, px, nx),
                                           (hp, tp, pp, np_)):
        np.testing.assert_array_equal(h, want_h)
        m = want_h
        np.testing.assert_allclose(t[m], want_t[m], rtol=1e-5, atol=1e-6)
        uniq = m & _unique_t(ptris, o.astype(np.float64),
                             d.astype(np.float64), tmax, t.astype(np.float64))
        assert uniq.sum() > 0.95 * m.sum()
        np.testing.assert_array_equal(p[uniq], want_p[uniq])
        np.testing.assert_array_equal(nrm[uniq], want_n[uniq])
    assert m.sum() > 300
    dead = ~active
    assert not h[dead].any() and (t[dead] == np.float32(P.BIG)).all()
    assert (p[dead] == -1).all() and not nrm[dead].any()
    assert (p[~h] == -1).all() and not nrm[~h].any()


@pytest.mark.parametrize("tmax_v", [np.inf, 0.7], ids=["inf", "0.7"])
def test_anyhit_matches_rtjax(scene, tmax_v):
    res, ptris, tables, ours = scene
    o, d, active, exclude = _inputs(21)
    tmax = np.full(N_RAYS, tmax_v, np.float32)
    occ = P.persist_traverse_anyhit(ours, _tt(o), _tt(d), _tt(tmax),
                                    _tt(exclude), _tt(active)).numpy()
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
            jnp.asarray(exclude), jnp.asarray(active))
    occ_x = np.asarray(traverse_anyhit(res.to_device(), ptris, *args))
    occ_p = np.asarray(jax_persist_anyhit(tables, *args, interpret=True))
    np.testing.assert_array_equal(occ, occ_x)
    np.testing.assert_array_equal(occ, occ_p)
    assert occ.sum() > 100 and not occ[~active].any()


def test_triple_and_array_layouts_agree(scene):
    """Component triples in -> triple normals out; [N, 3] in -> [N, 3]."""
    _, _, _, ours = scene
    o, d, active, _ = _inputs(9)
    tmax = _tt(np.full(N_RAYS, np.inf, np.float32))
    arr = P.persist_traverse_closest(ours, _tt(o), _tt(d), tmax,
                                     _tt(active))
    tri = P.persist_traverse_closest(
        ours, tuple(_tt(o[:, k]) for k in range(3)),
        tuple(_tt(d[:, k]) for k in range(3)), tmax, _tt(active))
    for a, b in zip(arr[:3], tri[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert isinstance(tri[3], tuple) and arr[3].shape == (N_RAYS, 3)
    np.testing.assert_array_equal(torch.stack(tri[3], -1).numpy(),
                                  arr[3].numpy())


def test_wrapper_rejects_bad_inputs(scene):
    _, _, _, ours = scene
    n = 64
    o = tuple(torch.zeros(n) for _ in range(3))
    d = tuple(torch.ones(n) for _ in range(3))
    tmax, act = torch.ones(n), torch.ones(n, dtype=torch.bool)
    with pytest.raises(TypeError):
        P.persist_traverse_closest(ours, o, d, tmax.double(), act)
    with pytest.raises(ValueError):
        P.persist_traverse_closest(ours, o, d, tmax[:10], act)
    with pytest.raises(ValueError):
        P.persist_traverse_closest(ours, o, (d[0][::2], d[1], d[2]), tmax,
                                   act)
    with pytest.raises(TypeError):
        P.persist_traverse_anyhit(ours, o, d, tmax,
                                  torch.zeros(n, dtype=torch.int64), act)
    deep = WideTables(ours.node_bounds, ours.child_meta, ours.node_info,
                      ours.leaf_tris, width=ours.width, depth=P.STACK)
    with pytest.raises(ValueError, match="stack"):
        P.persist_traverse_closest(deep, o, d, tmax, act)


def test_plain_versions_count_calls(scene):
    _, _, _, ours = scene
    n = 16
    o = tuple(torch.zeros(n) for _ in range(3))
    d = tuple(torch.ones(n) for _ in range(3))
    before = dict(P.REF_CALLS), dict(P.LAUNCHES)
    P.persist_traverse_closest(ours, o, d, torch.ones(n),
                               torch.ones(n, dtype=torch.bool))
    P.persist_traverse_anyhit(ours, o, d, torch.ones(n),
                              torch.full((n,), -1, dtype=torch.int32),
                              torch.ones(n, dtype=torch.bool))
    assert P.REF_CALLS["closest"] == before[0]["closest"] + 1
    assert P.REF_CALLS["anyhit"] == before[0]["anyhit"] + 1
    assert P.LAUNCHES == before[1]  # CPU tensors never reach the kernels
