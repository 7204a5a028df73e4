"""rtjax_torch's two-level kernels: the Python side of the fetch launch.

- the stack length of concatenated tables: the deepest of the base tree
  and every BLAS, plus 1;
- the shared memory per block: the stack, plus every instance's record
  when the records are staged; staged exactly while that fits the card's
  opt-in shared memory per block;
- the refusals: a stack beyond the kernels', tables not 16-byte aligned,
  root or affine on another device than the tables;
- the ``_stride`` wrappers take the plain version on CPU tensors, as the
  others do.

Hand-built tables and a small instanced scene; the kernels themselves run
only on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtjax_torch.accel.wide import InstancedTables, WideTables
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.scene.scene import SceneBuilder
from rtjax_torch.scene.transform import Transform, rotate, translate


def _scene(n_inst=3):
    """A floor and light (3 base triangles) under ``n_inst`` placements of
    a 200-triangle soup: the BLAS is deeper than the base."""
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    b.add_triangles([-3, 0, 3], [3, 0, 3], [3, 0, -3], white)
    b.add_triangles([-3, 0, 3], [-3, 0, -3], [3, 0, -3], white)
    b.add_area_light((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (0.5, 2.0, 0.5),
                     (20, 20, 20), white)
    rng = np.random.default_rng(5)
    v = rng.uniform(-0.3, 0.3, (600, 3)) + [0.0, 0.35, 0.0]
    mid = b.register_mesh(v, np.arange(600).reshape(200, 3))
    for i in range(n_inst):
        t = Transform(rotate([0, 1, 0], 0.61 * i))
        t.composite(translate(i * 0.9 - 0.9, 0.0, 0.0))
        b.add_instance(mid, white, t)
    return b.build("cpu")


def _records(n_inst, depth, width=8):
    """InstancedTables of ``n_inst`` zero records over two tiny 16-byte
    aligned nodes of the given ``depth``."""
    wide = WideTables.from_arrays(
        dict(node_bounds=np.zeros((2, 128), np.float32),
             child_meta=np.zeros((2, width), np.int32),
             node_info=np.zeros(2, np.int32),
             leaf_tris=np.zeros((1, 128), np.float32)),
        width=width, depth=depth, device="cpu")
    return InstancedTables(wide=wide,
                           root=torch.zeros(n_inst, dtype=torch.int32),
                           affine=torch.zeros(n_inst * WI.AFF))


def test_stack_length_is_the_deepest_tree_plus_one():
    scene = _scene()
    base, blas = scene.tables.depth, scene.blas[0].tables.depth
    assert blas > base
    it = scene.inst_tables
    assert it.wide.depth == max(base, blas)
    assert WI.launch_shape(it) == (blas + 1, True)


@pytest.mark.parametrize("n_inst", [1, 17, 257])
@pytest.mark.parametrize("depth", [0, 16, P.STACK - 1])
def test_shared_memory_holds_the_stack_and_the_records(n_inst, depth):
    it = _records(n_inst, depth)
    stack = 2 * 4 * (depth + 1) * 128
    assert WI.smem_bytes(it, False) == stack
    assert WI.smem_bytes(it, True) == stack + 76 * n_inst
    assert WI.staged(it)


@pytest.mark.parametrize("depth", [4, P.STACK - 1])
def test_records_are_staged_while_they_fit(depth):
    """The most instances whose records fit beside the stack in the card's
    227 KB of shared memory per block are staged; one more are read from
    global memory."""
    most = (WI.SMEM_OPTIN - 2 * 4 * (depth + 1) * 128) // 76
    assert WI.smem_bytes(_records(most, depth), True) <= 232_448
    assert WI.launch_shape(_records(most, depth)) == (depth + 1, True)
    assert WI.launch_shape(_records(most + 1, depth)) == (depth + 1, False)


def _rays(n=16):
    o = (torch.zeros(n), torch.full((n,), 0.3), torch.full((n,), 2.0))
    d = (torch.zeros(n), torch.zeros(n), torch.full((n,), -1.0))
    return o, d, torch.full((n,), float("inf")), torch.ones(n,
                                                            dtype=torch.bool)


def test_kernels_refuse_a_stack_beyond_theirs():
    it = _scene().inst_tables
    deep = dataclasses.replace(
        it, wide=dataclasses.replace(it.wide, depth=P.STACK))
    o, d, tmax, act = _rays()
    ex = torch.full((16,), -1, dtype=torch.int32)
    for call in (lambda t: WI.wide_traverse_closest_inst(t, o, d, tmax, act),
                 lambda t: WI.wide_traverse_anyhit_inst(t, o, d, tmax, ex,
                                                        act)):
        call(it)
        with pytest.raises(ValueError, match="stack entries"):
            call(deep)


def test_kernels_refuse_unaligned_tables():
    it = _records(4, 3)
    nb = it.wide.node_bounds
    shifted = torch.zeros(nb.numel() + 1)[1:].view_as(nb)
    bad = dataclasses.replace(it, wide=dataclasses.replace(
        it.wide, node_bounds=shifted))
    with pytest.raises(ValueError, match="16-byte aligned"):
        WI.launch_shape(bad)


@pytest.mark.parametrize("field", ["root", "affine"])
def test_kernels_refuse_records_on_another_device(field):
    it = _scene().inst_tables
    moved = dataclasses.replace(it, **{field: getattr(it, field).to("meta")})
    o, d, tmax, act = _rays()
    with pytest.raises(ValueError, match=f"{field} is on meta"):
        WI.wide_traverse_closest_inst(moved, o, d, tmax, act)


def test_stride_wrappers_take_the_plain_version_on_cpu():
    it = _scene().inst_tables
    g = torch.Generator().manual_seed(3)
    n = 400
    o = (torch.rand(n, generator=g) * 3 - 1.5,
         torch.rand(n, generator=g) * 0.6 + 0.05,
         torch.rand(n, generator=g) * 3 - 1.5)
    d = torch.randn(3, n, generator=g)
    d = tuple((d / d.norm(dim=0))[k].contiguous() for k in range(3))
    tmax = torch.full((n,), float("inf"))
    act = torch.rand(n, generator=g) > 0.1
    ex = torch.randint(-1, 3, (n,), generator=g, dtype=torch.int32)
    before = dict(WI.STRIDE_LAUNCHES)
    want = WI.wide_traverse_closest_inst_ref(it, o, d, tmax, act)
    got = WI.wide_traverse_closest_inst_stride(it, o, d, tmax, act)
    for a, b in zip(got[:4] + got[4], want[:4] + want[4]):
        assert torch.equal(a, b)
    assert int((got[3] > 0).sum()) > 0
    assert torch.equal(
        WI.wide_traverse_anyhit_inst_stride(it, o, d, tmax, ex, act),
        WI.wide_traverse_anyhit_inst_ref(it, o, d, tmax, ex, act))
    assert WI.STRIDE_LAUNCHES == before  # no kernel ran
