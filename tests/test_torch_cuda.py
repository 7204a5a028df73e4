"""rtjax_torch on a CUDA device: the hand-written kernels against their
plain PyTorch versions, and the engine's main path through the kernels.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  The file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernel and plain version walk the same visit order and round the same
operations (the kernels build with --fmad=false), so they must agree bit
for bit, ties included.
"""

import numpy as np
import pytest
import torch

from rtjax_torch import RenderConfig
from rtjax_torch.accel.builder_cpp import build_bvh
from rtjax_torch.accel.wide import build_wide_tables
from rtjax_torch.kernels import persist as P
from rtjax_torch.render.wavefront import render_frame
from rtjax_torch.scenes import cornell_planes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _soup_tables(width, device):
    """Wide tables of 300 random triangles."""
    rng = np.random.default_rng(11)
    p0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    res = build_bvh(np.minimum(np.minimum(p0, p1), p2),
                    np.maximum(np.maximum(p0, p1), p2), (p0 + p1 + p2) / 3.0,
                    max_leaf_size=8, min_leaf_size=8)
    pp0, e1, e2 = p0[res.perm], (p0 - p1)[res.perm], (p2 - p0)[res.perm]
    return build_wide_tables(res, pp0, e1, e2, np.cross(e1, e2), device,
                             width=width)


def _rays(n, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    o = tuple(torch.rand(n, generator=g, device=device) * 4 - 2
              for _ in range(3))
    d = torch.randn(3, n, generator=g, device=device)
    d = d / d.norm(dim=0)
    active = torch.rand(n, generator=g, device=device) > 0.1
    exclude = torch.randint(-1, 300, (n,), generator=g, device=device,
                            dtype=torch.int32)
    return o, tuple(d[k].contiguous() for k in range(3)), active, exclude


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("tmax_v", [float("inf"), 0.7], ids=["inf", "0.7"])
def test_kernels_equal_plain_versions(cuda, width, tmax_v):
    tables = _soup_tables(width, cuda)
    assert tables.width == width
    n = 3 * 2048 + 300
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), tmax_v, device=cuda)
    args = (tables, o, d, tmax, active)
    k_out = P.persist_traverse_closest(*args)
    p_out = P.persist_traverse_closest_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(k_out[:3] + k_out[3], p_out[:3] + p_out[3]):
        assert torch.equal(a, b)
    assert int(k_out[0].sum()) > 300
    args = (tables, o, d, tmax, exclude, active)
    occ = P.persist_traverse_anyhit(*args)
    assert torch.equal(occ, P.persist_traverse_anyhit_ref(*args))
    assert not bool(occ[~active].any())


def test_kernels_refuse_mixed_devices(cuda):
    tables = _soup_tables(8, cuda)
    o, d, active, _ = _rays(64, torch.device("cpu"))
    with pytest.raises(ValueError, match="tables on cuda"):
        P.persist_traverse_closest(tables, o, d, torch.ones(64), active)


def test_main_path_runs_through_the_kernels(cuda):
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096)
    launches, refs = dict(P.LAUNCHES), dict(P.REF_CALLS)
    fb, stats = render_frame(scene, cam, cfg,
                             torch.Generator(device=cuda).manual_seed(1))
    assert P.REF_CALLS == refs
    for k in ("closest", "anyhit"):
        assert P.LAUNCHES[k] - launches[k] == stats["iterations"]
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
    assert stats["rays_traced"] >= 32 * 32 * 8
