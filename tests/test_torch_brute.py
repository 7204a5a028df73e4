"""rtjax_torch.kernels.brute (the all-triangles oracle) against rtjax's
``closest_brute`` / ``anyhit_brute`` on the same triangles and rays.

rtjax steps op by op (``jax.disable_jit()``), so that neither side
contracts multiply-adds: ``hit``, ``prim`` and occlusion must be equal;
``t``, ``u`` and ``v`` are held on the hit rays at rtol 1e-5 (the
ROADMAP's rule for comparing with rtjax on the CPU).  The triangles go in
chunks of several sizes (``brute.CHUNK_ELEMENTS`` patched), which must not
change a bit of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax.core.geometry import Triangles as JaxTriangles
from rtjax.kernels import brute as jax_brute

from rtjax_torch.core.geometry import Triangles
from rtjax_torch.kernels import brute

N_TRIS = 400
N_RAYS = 700


def _soup():
    rng = np.random.default_rng(17)
    p0 = rng.uniform(-1, 1, (N_TRIS, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.3, 0.3, (N_TRIS, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-0.3, 0.3, (N_TRIS, 3))).astype(np.float32)
    return p0, p1, p2


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (N_RAYS, 3)).astype(np.float32)
    target = rng.uniform(-0.8, 0.8, (N_RAYS, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(N_RAYS) < 0.3, 1.0,
                    np.inf).astype(np.float32)
    active = rng.random(N_RAYS) > 0.1
    exclude = np.where(rng.random(N_RAYS) < 0.5,
                       rng.integers(0, N_TRIS, N_RAYS), -1).astype(np.int32)
    return o, d.astype(np.float32), tmax, active, exclude


@pytest.fixture(scope="module")
def tris():
    p0, p1, p2 = _soup()
    return (Triangles.from_vertices(p0, p1, p2, "cpu"),
            JaxTriangles.from_vertices(p0, p1, p2))


CHUNKS = [N_TRIS, 7, 128]


@pytest.fixture(params=CHUNKS, ids=["whole", "7", "128"])
def chunk(request, monkeypatch):
    """Triangles a chunk, for N_RAYS rays."""
    monkeypatch.setattr(brute, "CHUNK_ELEMENTS", request.param * N_RAYS)
    return request.param


def test_closest_brute_matches_rtjax(tris, chunk):
    ours, theirs = tris
    o, d, tmax, active, _ = _rays(3)
    got = [a.numpy() for a in brute.closest_brute(
        ours, torch.tensor(o), torch.tensor(d), torch.tensor(tmax),
        torch.tensor(active))]
    with jax.disable_jit():
        want = [np.asarray(a) for a in jax_brute.closest_brute(
            theirs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
            jnp.asarray(active))]
    hit, t, u, v, prim, normal = got
    np.testing.assert_array_equal(hit, want[0])
    np.testing.assert_array_equal(prim, want[4])
    for a, b in ((t, want[1]), (u, want[2]), (v, want[3])):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(normal, want[5], rtol=1e-5, atol=1e-7)
    assert hit.sum() > 150 and (~hit & active).sum() > 50
    assert not hit[~active].any() and not normal[~hit].any()
    # a miss keeps prim -1
    assert (prim[~hit & active] == -1).all()


def test_anyhit_brute_matches_rtjax(tris, chunk):
    ours, theirs = tris
    o, d, tmax, active, exclude = _rays(5)
    occ = brute.anyhit_brute(ours, torch.tensor(o), torch.tensor(d),
                             torch.tensor(tmax), torch.tensor(exclude),
                             torch.tensor(active)).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_brute.anyhit_brute(
            theirs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
            jnp.asarray(exclude), jnp.asarray(active)))
    np.testing.assert_array_equal(occ, want)
    assert occ.sum() > 150 and (~occ & active).sum() > 50


def test_closest_brute_keeps_the_first_of_equal_t(monkeypatch):
    """Two coincident triangles: the lower index is kept, in any chunking
    (a split falls between them)."""
    p0 = np.array([[0, 0, 0], [0, 0, 0], [5, 5, 5]], np.float32)
    p1 = np.array([[1, 0, 0], [1, 0, 0], [6, 5, 5]], np.float32)
    p2 = np.array([[0, 1, 0], [0, 1, 0], [5, 6, 5]], np.float32)
    tri = Triangles.from_vertices(p0, p1, p2, "cpu")
    o = torch.tensor([[0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    for chunk in (3, 1, 2):
        monkeypatch.setattr(brute, "CHUNK_ELEMENTS", chunk)
        hit, t, _, _, prim, _ = brute.closest_brute(
            tri, o, d, torch.tensor([np.inf], dtype=torch.float32),
            torch.tensor([True]))
        assert bool(hit[0]) and int(prim[0]) == 0 and float(t[0]) == 1.0
