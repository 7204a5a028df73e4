"""``detailed_stats`` under every walker: the packet, lane and two-level
kernels' counts (their stats instances on the card, the plain walks with a
work count here), against rtjax and against the plain walks.

State for state, as ``test_torch_modes.py`` steps ``detailed_stats``: rtjax
steps op by op (``jax.disable_jit()``) on its sorted engine and the port is
re-seeded from rtjax's carry each iteration with rtjax's random words.
rtjax steps under its default traversal: on these scenes of at most 64
triangles a mesh, its direct all-triangles loop, whose hits the port's
packet, lane and two-level walks reproduce (tests/test_torch_packet.py
holds the packet walk to rtjax's interpret-mode packet kernels state for
state; rtjax's packet, lane and two-level kernels in interpret mode take
10-30 s a step here).  The port steps under ``walker="packet"``,
``walker="lane"``, ``anyhit_walker="packet"`` and ``two_level="kernel"``,
its own direct path off (``direct_max_tris=0``), so that its walkers run.
The bounce histogram, ``rays_traced``, ``hit`` and ``bounces`` equal
rtjax's exactly; the node and leaf counts (rtjax's count TPU walk rounds)
equal the ``new_work()`` counts of the plain walks of every launch,
recounted beside the engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import Camera as JaxCamera
from rtjax import RenderConfig as JaxConfig
from rtjax.core import rng as jax_rng
from rtjax.render import wavefront as jax_wf

from rtjax_torch import RenderConfig
from rtjax_torch.kernels import lane as L
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide as WD
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.render import trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays

from scenes import cornell, default_camera
from test_torch_instancing import _jax_scene, _port_scene, inst_scene_arrays
from test_torch_scene import camera_arrays, scene_arrays
from test_torch_wavefront import _port_carry

POOL = 1024
W = H = 16
ITERS = 2


def _recount(name, args):
    """``(node_visits, leaf_rows)`` of the plain walk behind the wrapper
    ``name`` on the same arguments, counted by ``persist.new_work()``."""
    work = P.new_work()
    if name.startswith("wide_traverse") and name.endswith("_inst"):
        ref = {"wide_traverse_closest_inst": WI.wide_traverse_closest_inst_ref,
               "wide_traverse_anyhit_inst": WI.wide_traverse_anyhit_inst_ref}
        ref[name](*args, work=work)
    elif name.startswith("persist"):
        ref = {"persist_traverse_closest": P.persist_traverse_closest_ref,
               "persist_traverse_anyhit": P.persist_traverse_anyhit_ref}
        ref[name](*args, work=work)
    elif name.endswith("closest"):
        group = L.LANE if name.startswith("lane") else WD.PACKET
        WD.group_traverse_closest_ref(*args, group, work=work)
    else:
        WD.group_traverse_anyhit_ref(*args, WD.PACKET, work=work)
    return work["node_visits"], work["leaf_rows"]


class _Recount:
    """Wraps render/trace.py's kernel wrappers: records which ran, and sums
    the recounted plain-walk counts of each channel's launches."""

    NAMES = ("persist_traverse_closest", "persist_traverse_anyhit",
             "wide_traverse_closest", "wide_traverse_anyhit",
             "lane_traverse_closest", "wide_traverse_closest_inst",
             "wide_traverse_anyhit_inst")

    def __init__(self, monkeypatch):
        self.used = set()
        self.launches = {"closest": 0, "anyhit": 0}
        self.sums = {"closest": [0, 0], "anyhit": [0, 0]}
        for name in self.NAMES:
            monkeypatch.setattr(trace, name,
                                self._wrap(name, getattr(trace, name)))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            self.used.add(name)
            out = fn(*args, **kw)
            if not kw.get("with_stats"):
                return out
            counts = _recount(name, args)
            got = out[-1]
            assert (int(got[0]), int(got[1])) == counts, name
            kind = "anyhit" if "anyhit" in name else "closest"
            self.launches[kind] += 1
            self.sums[kind][0] += counts[0]
            self.sums[kind][1] += counts[1]
            return out
        return call


def _stats_carry(jc, steps):
    """The port's carry from rtjax's, with the histogram and the port's
    own running counts (``steps``)."""
    return _port_carry(jc) + (
        torch.tensor(np.asarray(jc[7]), dtype=torch.int64),) + steps


def _zero_jc(pool, cfg):
    return (jax_wf.make_initial_state(pool),
            jnp.zeros((cfg.num_pixels, 3), jnp.float32), jnp.int32(0),
            jnp.int32(0), jnp.bool_(False), jnp.float32(0), jnp.float32(0),
            jnp.zeros(cfg.max_bounces + 1, jnp.int32)) + (jnp.int32(0),) * 4


def _rtjax_steps(jscene, jcam, kw, seed):
    """rtjax's carries and random words of ITERS iterations from a fresh
    frame: ``[(carry before, words, carry after), ...]``."""
    jcfg = JaxConfig(traversal="pallas", sort_every=0, detailed_stats=True,
                     **kw)
    key = jax.random.key(seed)
    jc = _zero_jc(kw["num_working_paths"], jcfg)
    steps = []
    for it in range(ITERS):
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(
                key, jnp.int32(it), 5, kw["num_working_paths"])
            ).astype(np.int64)
            nxt = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc)
        steps.append((jc, words, nxt))
        jc = nxt
    return steps


def _check_steps(scene, cam, cfg, steps, rec):
    """Step the port from each of rtjax's carries; compare."""
    zero = torch.zeros((), dtype=torch.int64)
    counts = (zero,) * 4
    for jc, words, want in steps:
        before = [int(v) for v in counts]
        sums = {k: list(v) for k, v in rec.sums.items()}
        c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words),
                              _stats_carry(jc, counts))
        np.testing.assert_array_equal(c[7].numpy(), np.asarray(want[7]))
        assert float(c[5]) == float(want[5]), "rays traced"
        for f in ("hit", "bounces"):
            np.testing.assert_array_equal(getattr(c[0], f).numpy(),
                                          np.asarray(getattr(want[0], f)),
                                          err_msg=f)
        counts = c[8:]
        got = [int(v) - b for v, b in zip(counts, before)]
        assert got == [rec.sums["closest"][0] - sums["closest"][0],
                       rec.sums["closest"][1] - sums["closest"][1],
                       rec.sums["anyhit"][0] - sums["anyhit"][0],
                       rec.sums["anyhit"][1] - sums["anyhit"][1]]
    # the first iteration traces camera rays only; the second both channels
    assert all(int(v) > 0 for v in counts)
    assert int(c[0].hit.sum()) > POOL // 4


@pytest.fixture(scope="module")
def single():
    """The Cornell box (32 triangles) in both packages, and rtjax's
    detailed_stats steps."""
    jscene, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    kw = dict(width=W, height=H, num_samples=8, max_bounces=4,
              num_working_paths=POOL)
    return (scene_from_arrays(scene_arrays(jscene), "cpu"),
            Camera.from_arrays(camera_arrays(jcam), "cpu"), kw,
            _rtjax_steps(jscene, jcam, kw, 2))


@pytest.mark.parametrize("walkers, used", [
    (dict(walker="packet"),
     {"wide_traverse_closest", "persist_traverse_anyhit"}),
    (dict(walker="lane"),
     {"lane_traverse_closest", "persist_traverse_anyhit"}),
    (dict(anyhit_walker="packet"),
     {"persist_traverse_closest", "wide_traverse_anyhit"}),
], ids=["packet", "lane", "anyhit_packet"])
def test_walker_stats_match_rtjax(single, monkeypatch, walkers, used):
    scene, cam, kw, steps = single
    rec = _Recount(monkeypatch)
    cfg = RenderConfig(detailed_stats=True, direct_max_tris=0, **walkers,
                       **kw)
    _check_steps(scene, cam, cfg, steps, rec)
    assert rec.used == used


def test_two_level_kernel_stats_match_rtjax(monkeypatch):
    """17 instances of a 64-triangle mesh: rtjax's repass over its direct
    loop, the port's two-level kernels (their plain versions)."""
    jscene = _jax_scene("field17")
    jcam = JaxCamera.make((0, 2.5, 3.5), (0, 0.1, 0), (0, 1, 0), 45, 1.0)
    kw = dict(width=W, height=H, num_samples=8, max_bounces=4,
              num_working_paths=POOL)
    steps = _rtjax_steps(jscene, jcam, kw, 3)
    scene = scene_from_arrays(inst_scene_arrays(jscene), "cpu")
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    rec = _Recount(monkeypatch)
    cfg = RenderConfig(detailed_stats=True, two_level="kernel", **kw)
    _check_steps(scene, cam, cfg, steps, rec)
    assert rec.used == {"wide_traverse_closest_inst",
                        "wide_traverse_anyhit_inst"}


def test_repass_stats_sum_every_pass_under_the_packet_walker(monkeypatch):
    """Under repass with ``walker="packet"`` (and the packet any-hit
    walker) every launch is a packet launch, and the counts of
    trace_closest / trace_anyhit are the sum of the base launch's and
    every pass's."""
    scene = _port_scene("field17")
    cfg = RenderConfig(detailed_stats=True, two_level="repass",
                       walker="packet", anyhit_walker="packet",
                       direct_max_tris=0)
    g = np.random.default_rng(5)
    n = 512
    o = (torch.tensor(g.uniform(-1.5, 1.5, n).astype(np.float32)),
         torch.full((n,), 1.0), torch.tensor(
             g.uniform(-1.5, 1.5, n).astype(np.float32)))
    d = (torch.tensor(g.uniform(-0.3, 0.3, n).astype(np.float32)),
         torch.full((n,), -1.0), torch.tensor(
             g.uniform(-0.3, 0.3, n).astype(np.float32)))
    d = tuple(c / torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2) for c in d)
    active = torch.ones(n, dtype=torch.bool)
    inf = torch.full((n,), float("inf"))
    rec = _Recount(monkeypatch)
    *res, st = trace.trace_closest(scene, cfg, o, d, inf, active,
                                   with_stats=True)
    occ, ast = trace.trace_anyhit(scene, cfg, o, d, torch.full((n,), 0.9),
                                  torch.full((n,), -1, dtype=torch.int32),
                                  active, with_stats=True)
    assert rec.used == {"wide_traverse_closest", "wide_traverse_anyhit"}
    # the base launch and at least one BLAS pass per channel
    assert rec.launches["closest"] > 1 and rec.launches["anyhit"] > 1
    assert [int(st[0]), int(st[1])] == rec.sums["closest"]
    assert [int(ast[0]), int(ast[1])] == rec.sums["anyhit"]
    plain = trace.trace_closest(scene, dataclasses.replace(
        cfg, detailed_stats=False), o, d, inf, active)
    for a, b in zip(plain, res):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert bool(res[0].any()) and bool((res[3] > 0).any())


def test_default_path_passes_no_stats_keyword(single, monkeypatch):
    """Without ``detailed_stats`` the wrappers are called as before
    counting existed, with no ``with_stats`` keyword: a first design
    rebound in render/trace.py's names to time it (``chip_smoke.py``
    phase 7, ``tools/persist_variants.py``) takes no such argument."""
    scene, cam, kw, _ = single
    seen = []

    def plain_args(fn):
        def call(tables, o, d, tmax, *rest):
            seen.append(fn.__name__)
            return fn(tables, o, d, tmax, *rest)
        return call

    for name in ("wide_traverse_closest", "wide_traverse_anyhit"):
        monkeypatch.setattr(trace, name, plain_args(getattr(trace, name)))
    cfg = RenderConfig(walker="packet", anyhit_walker="packet",
                       direct_max_tris=0, **dict(kw, num_samples=1))
    fb, _ = wf.render_frame(scene, cam, cfg, torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(fb).all())
    assert set(seen) == {"wide_traverse_closest", "wide_traverse_anyhit"}
    inst = _port_scene("pyramid3")
    for name in ("wide_traverse_closest_inst", "wide_traverse_anyhit_inst"):
        monkeypatch.setattr(trace, name, plain_args(getattr(trace, name)))
    o = (torch.full((8,), 0.3), torch.full((8,), 0.5), torch.full((8,), -0.3))
    d = (torch.zeros(8), torch.full((8,), -1.0), torch.zeros(8))
    cfg = RenderConfig(two_level="kernel")
    trace.trace_closest(inst, cfg, o, d, torch.full((8,), float("inf")),
                        torch.ones(8, dtype=torch.bool))
    trace.trace_anyhit(inst, cfg, o, d, torch.full((8,), 2.0),
                       torch.full((8,), -1, dtype=torch.int32),
                       torch.ones(8, dtype=torch.bool))
    assert {"wide_traverse_closest_inst", "wide_traverse_anyhit_inst"} <= \
        set(seen)
