"""rtjax_torch's lane kernels: the Python side of their launch and the
plain walk's two any-hit rules at one warp's rays.

- the launch's rules: each warp's child-id stack and shared-memory bytes
  at widths 8 and 16, the warps a block takes from the depth (the
  headline's, config 4's BLAS and its baked tables at full width), the
  deepest tree a block holds, and the refusal past it;
- the engine's routing: past that depth ``walker="lane"`` warns once and
  traces with the packet kernels, as rtjax does for an ineligible lane
  tree;
- the any-hit rules of the plain group walk at ``lane.LANE`` on the
  hand-built three-node scene and on a random soup: equal occlusion, and
  rtjax's lane rule (``decide_first`` False, the lane kernels' first
  design) never visiting more nodes than deciding first (True, the lane
  kernels' design);
- the lane wrappers on CPU tensors run the plain walk, never a kernel, and
  fill the child-id stack of a chain.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses
import types
import warnings

import pytest
import torch

from rtjax_torch import RenderConfig
from rtjax_torch.accel.wide import WideTables
from rtjax_torch.kernels import lane as L
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide as WD
from rtjax_torch.render import trace

from test_torch_persist_work import (HAND_RAYS, _hand_rays, _hand_tables,
                                     _soup, _soup_rays, chain_rays,
                                     chain_tables)


def _tables(width, depth):
    return WideTables(*(torch.zeros(1) for _ in range(4)), width=width,
                      depth=depth)


@pytest.mark.parametrize("width, depth, warps", [
    (16, 18, 8),     # the headline scene
    (16, 16, 8),     # config 4's BLAS
    (8, 21, 8),      # config 4's baked tables
    (16, 440, 8), (16, 441, 7), (16, 3830, 1),
    (8, 961, 8), (8, 962, 7), (8, 8225, 1)])
def test_launch_shape_follows_the_depth(width, depth, warps):
    """A warp holds two node rows (7 words a child slot), LANE_ROWS leaf
    rows of 104 words and its child-id stack, (depth + 1) * (width - 1)
    ids rounded up to 16 bytes; a block takes LANE_WARPS warps where they
    fit the card's opt-in shared memory, fewer down to one for deeper
    trees."""
    tables = _tables(width, depth)
    stack = (depth + 1) * (width - 1)
    shared = {16: 2560, 8: 2112}[width]
    per = shared + -(-4 * stack // 16) * 16
    assert L.lane_stack_len(tables) == stack
    assert L.warp_bytes(tables) == per
    assert L.fits(tables)
    assert L.launch_shape(tables) == (stack, warps, warps * per)
    assert warps * per <= L.SMEM_OPTIN < (warps + 1) * per \
        or warps == L.LANE_WARPS


@pytest.mark.parametrize("width, depth", [(16, 3831), (8, 8226)])
def test_a_block_refuses_a_deeper_tree(width, depth):
    tables = _tables(width, depth)
    assert not L.fits(tables)
    assert not L.fits(_tables(width, depth + 100))
    assert L.fits(_tables(width, depth - 1))
    with pytest.raises(ValueError, match="shared memory"):
        L.launch_shape(tables)


class _Spy:
    """Records which closest-hit wrappers the engine calls."""

    NAMES = ("persist_traverse_closest", "wide_traverse_closest",
             "lane_traverse_closest")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            fn = getattr(trace, name)
            monkeypatch.setattr(trace, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            self.calls.append(name)
            return fn(*args, **kw)
        return call


def _trace(tables, cfg):
    o, d, tmax, act = _hand_rays(range(len(HAND_RAYS)))
    # the hand-built scene's four triangles, above cfg.direct_max_tris
    sc = types.SimpleNamespace(instances=None, tables=tables,
                               tris=types.SimpleNamespace(num=4))
    return trace.trace_closest(sc, cfg, o, d, tmax, act)


def test_lane_walker_past_its_depth_warns_once_and_takes_packet(
        monkeypatch):
    """Within the depth a block holds, ``walker="lane"`` traces with the
    lane kernels and says nothing; past it, it warns (once at one call site
    under Python's default filter) and traces with the packet kernels,
    which find the same hits."""
    base = _hand_tables()
    deep = dataclasses.replace(base, depth=8226)
    assert L.fits(base) and not L.fits(deep)
    spy = _Spy(monkeypatch)
    cfg = RenderConfig(walker="lane", direct_max_tris=0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        want = _trace(base, cfg)
    assert spy.calls == ["lane_traverse_closest"] and not seen
    spy.calls.clear()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        for _ in range(3):
            got = _trace(deep, cfg)
    assert spy.calls == ["wide_traverse_closest"] * 3
    assert [str(w.message) for w in seen if "walker='lane'" in
            str(w.message)] == [str(seen[0].message)]
    assert "packet walker" in str(seen[0].message)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)


def _slanted_rays():
    """The hand-built scene's rays and one that leaf A occludes at the root
    while its slab also accepts internal node 1 (it leaves leaf A's
    triangle at z = 0.5 and enters node 1's box at x = 2)."""
    o, d, tmax, act = _hand_rays(range(len(HAND_RAYS)))
    n = o[0].shape[0] + 1
    norm = (1.0 + 0.2 ** 2) ** 0.5
    o = tuple(torch.cat([c, torch.tensor([v])]) for c, v in
              zip(o, (0.1, 0.1, 0.4)))
    d = tuple(torch.cat([c, torch.tensor([v])]) for c, v in
              zip(d, (1.0 / norm, 0.0, 0.2 / norm)))
    return o, d, torch.full((n,), float("inf")), torch.ones(n,
                                                            dtype=torch.bool)


def test_lane_rule_on_the_hand_built_scene():
    """The lane group of the hand-built scene's rays: occlusion equal under
    both any-hit rules and to the persist walk's; the lane rule visits no
    more nodes and tests no more slabs than deciding first."""
    tables = _hand_tables()
    o, d, tmax, act = _slanted_rays()
    ex = torch.full((tmax.shape[0],), -1, dtype=torch.int32)
    want = P.persist_traverse_anyhit_ref(tables, o, d, tmax, ex, act)
    assert want.tolist() == [False, True, True, True, True]
    counts = {}
    for first in (False, True):
        work = P.new_work()
        occ = WD.group_traverse_anyhit_ref(tables, o, d, tmax, ex, act,
                                           L.LANE, work=work,
                                           decide_first=first)
        assert torch.equal(occ, want), first
        counts[first] = work
    for k in ("node_visits", "slab_tests", "leaf_rows", "tri_slots"):
        assert counts[False][k] <= counts[True][k], k


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_lane_rule_visits_fewer_nodes(width):
    """On a random soup the lane rule visits no more nodes than deciding
    first, and the same occlusion.  At width 16, where leaves and internal
    children share nodes, an occluded ray's children are left out: strictly
    fewer visits; at width 8 this soup's counts are equal."""
    tables = _soup(width)
    o, d, tmax, act, ex = _soup_rays(1500, seed=9)
    counts, occ = {}, {}
    for first in (False, True):
        work = P.new_work()
        occ[first] = WD.group_traverse_anyhit_ref(
            tables, o, d, tmax, ex, act, L.LANE, work=work,
            decide_first=first)
        counts[first] = work
    assert torch.equal(occ[True], occ[False]) and bool(occ[True].any())
    for k in ("node_visits", "slab_tests"):
        assert counts[False][k] <= counts[True][k], k
        assert (counts[False][k] < counts[True][k]) == (width == 16), k


def test_lane_wrappers_on_cpu_run_the_plain_walk():
    """CPU tensors reach the plain group walk at LANE, never a kernel, in
    both designs' wrappers; a chain fills the child-id stack to its
    (depth + 1) * (width - 1) entries."""
    tables = chain_tables(8, 12)
    n = 2 * L.LANE + 9
    o, d, act, ex = chain_rays(n)
    tmax = torch.full((n,), float("inf"))
    work = P.new_work()
    want = WD.group_traverse_closest_ref(tables, o, d, tmax, act, L.LANE,
                                         work=work)
    assert work["stack_peak"] == L.lane_stack_len(tables) == 12 * 7
    launches = dict(L.LAUNCHES), dict(L.GROUP_LAUNCHES), dict(WD.LAUNCHES)
    refs = dict(WD.REF_CALLS)
    for closest, anyhit in ((L.lane_traverse_closest, L.lane_traverse_anyhit),
                            (L.lane_traverse_closest_group,
                             L.lane_traverse_anyhit_group)):
        got = closest(tables, o, d, tmax, act)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        assert bool(anyhit(tables, o, d, tmax, ex, act).all())
    assert (dict(L.LAUNCHES), dict(L.GROUP_LAUNCHES),
            dict(WD.LAUNCHES)) == launches
    assert WD.REF_CALLS == {k: v + 2 for k, v in refs.items()}
