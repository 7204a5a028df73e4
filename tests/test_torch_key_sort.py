"""The step's stable key sort (rtjax_torch/kernels/sort.py), whose CUDA
kernels (csrc/key_sort.cu) run only on the card (tests/test_torch_cuda.py);
here their arithmetic (csrc/key_sort.cuh) compiled as host C++ and the
plain version.

(a) tests/key_sort_host.cpp runs the kernels' passes tile by tile with
    their tile and digit sizes, bound through the real wrapper: its
    permutation equals ``np.argsort(kind="stable")`` and the plain version
    on tools/sort_designs.py's key sets (constant keys, the dead classes,
    sorted, reversed, random 31-bit and int32 keys, the extremes, two
    keys, a late iteration's pool) at 1, 1000, one tile - 1, one tile,
    one tile + 1 and 2^17 - 3 keys.
(b) The plain version's permutation equals rtjax's ``lax.sort``
    (``sort_pytree_by_key``) on the keys of an rtjax step, for every
    ``sort_key``, with the dirty class; they are also route's keys.
(c) On a ``sort_every`` skip iteration a launch returns at once, the
    order as it was, and counts itself as such; shade (plain and compiled
    as host C++) gives the same state whatever the order holds.
(d) A CPU frame through the compiled sort launches it once an iteration
    of every sorted path (the default engine with its cadence, parity, the
    wide bundle) and gives the plain sort's frame bit for bit; the plain
    version counts one call an iteration; the unsorted engine sorts
    nothing.
(e) The wrapper's input checks, the library's entry points against the
    host stand-in's, and the scratch's layout.
"""

import ctypes
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax.core import rng as jax_rng
from rtjax.render import sorting as jax_sorting
from rtjax.render import wavefront as jax_wf

from rtjax_torch import RenderConfig
from rtjax_torch.kernels import _build
from rtjax_torch.kernels import sort as SO
from rtjax_torch.kernels import step as S
from rtjax_torch.render import wavefront as wf
from rtjax_torch.render.wavefront import render_frame
from rtjax_torch.scenes import cornell_planes

from test_torch_step_kernels import (POOL, _copy_state, _jax_carry, _narrow,
                                     _synthetic_state, _words, mixed)
from test_torch_step_kernels import _host_kernels as _host_step

sys.path.insert(0, str(_build.REPO_ROOT / "tools"))
import sort_designs as SD  # noqa: E402

assert mixed   # the module fixture


def _host_sort():
    """csrc/key_sort.cuh compiled as host C++ with the kernels' launch
    logic (tests/key_sort_host.cpp), bound as the sort's library."""
    src = Path(__file__).with_name("key_sort_host.cpp")
    out = _build._build(
        _build.BUILD_DIR / "libkey_sort_host.so", [src],
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         f"-I{_build.CSRC_DIR}"], (_build.SORT_HEADER,))
    return SO.bind(ctypes.CDLL(str(out)))


def _on_host(monkeypatch):
    """The sort's card path on CPU tensors, over the host-compiled
    library."""
    monkeypatch.setattr(SO, "_lib", _host_sort())
    monkeypatch.setattr(SO, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))


# ------------------------------------------- (a) the passes on the host

def _size(name):
    tile = 256 * 8   # csrc/key_sort.cuh kTile
    return {"1": 1, "1000": 1000, "tile-1": tile - 1, "tile": tile,
            "tile+1": tile + 1, "2^17-3": (1 << 17) - 3}[name]


@pytest.mark.parametrize("size", ["1", "1000", "tile-1", "tile", "tile+1",
                                  "2^17-3"])
@pytest.mark.parametrize("keyset", SD.SETS)
def test_host_passes_equal_a_stable_argsort(monkeypatch, keyset, size):
    """The kernels' passes, run tile by tile on the host, give the stable
    permutation: ``np.argsort(kind="stable")`` and the plain version."""
    n = _size(size)
    keys = SD.synthetic_keys(keyset, n, seed=n)
    want = np.argsort(keys, kind="stable")
    plain = SO.stable_order(torch.from_numpy(keys))
    np.testing.assert_array_equal(plain.numpy(), want)
    _on_host(monkeypatch)
    got = SO.stable_order(torch.from_numpy(keys))
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------ (b) against rtjax's lax.sort

@pytest.mark.parametrize("sort_key", ["morton", "morton_pos",
                                      "morton_pos10", "prim", "prim_pos",
                                      "normal_pos", "adaptive"])
def test_plain_version_equals_rtjax_lax_sort(mixed, monkeypatch, sort_key):
    """The keys rtjax's step sorts (recorded from its
    ``sort_pytree_by_key``, op by op, the dirty class among them) are
    route's keys, and the plain version's permutation of them is rtjax's
    ``lax.sort`` permutation, as is the host-compiled passes'."""
    jscene, jcam, scene, _ = mixed
    kw = dict(width=16, height=16, num_samples=4, max_bounces=4,
              num_working_paths=POOL, sort_every=1, sort_key=sort_key)
    cfg = RenderConfig(**kw)
    state = _synthetic_state(scene, cfg, 6)
    c = (state, torch.zeros(cfg.num_pixels, 3), torch.tensor(300), 2,
         torch.tensor(False), torch.tensor(0.0, dtype=torch.float64),
         torch.tensor(0.0, dtype=torch.float64))
    seen = []
    real = jax_sorting.sort_pytree_by_key

    def record(keys, tree):
        seen.append(np.asarray(keys))
        return real(keys, tree)
    monkeypatch.setattr(jax_wf, "sort_pytree_by_key", record)
    key = jax.random.key(5)
    with jax.disable_jit():
        words = np.asarray(jax_rng.bits_block(key, jnp.int32(2), 5,
                                              POOL)).astype(np.int64)
        jax_wf.wavefront_step(jscene, jcam, JaxConfig(traversal="pallas",
                                                      **kw), key,
                              _jax_carry(c))
        assert len(seen) == 1
        keys = seen[0]
        perm = np.asarray(real(jnp.asarray(keys),
                               jnp.arange(POOL, dtype=jnp.int32)))
    assert (keys == S.DIRTY_KEY).sum() > 0 and (keys < S.DIRTY_KEY).sum() > 0
    mine = S.route_ref(scene, cfg, state, torch.tensor(words))[0]
    np.testing.assert_array_equal(mine.numpy(), keys)
    np.testing.assert_array_equal(SO.stable_order_ref(mine).numpy(), perm)
    _on_host(monkeypatch)
    np.testing.assert_array_equal(SO.stable_order(mine).numpy(), perm)


# ---------------------------------------------- (c) the cadence's skips

@pytest.mark.parametrize("it", [1, "tensor 1", 2, "few continue"])
def test_skip_launch_returns_at_once(monkeypatch, it):
    """With the cadence of ``sort_every`` 2 a launch sorts on an even
    iteration, or when fewer than 3/4 of the lanes continue; else it
    returns at once, the order as it was, and the tally counts it as
    returned at once."""
    _on_host(monkeypatch)
    n = 3000
    keys = torch.from_numpy(SD.synthetic_keys("random31", n, 4))
    counts = torch.tensor([n // 2 if it == "few continue" else n, 0, 0, 0,
                           0])
    i = {"tensor 1": torch.tensor(1), "few continue": 1}.get(it, it)
    out = torch.full((n,), -7, dtype=torch.int64)
    before = SO.tally("cpu").clone()
    got = SO.sort_into(keys, out, (counts, i, 2))
    sorts = it in (2, "few continue")
    assert bool(S.cadence(counts, n, i, 2)) == sorts
    want = torch.sort(keys, stable=True).indices if sorts else \
        torch.full((n,), -7, dtype=torch.int64)
    assert got is out and torch.equal(got, want)
    assert (SO.tally("cpu") - before).tolist() == ([1, 0] if sorts
                                                   else [0, 1])


def test_shade_ignores_the_order_on_a_skip(mixed, monkeypatch):
    """On a ``sort_every`` skip iteration (nine in ten lanes continue, it
    odd) shade reads the identity: its plain version and its kernel
    compiled as host C++ give the same next state and framebuffer whatever
    ``order`` holds (the sorted order or words no gather could take), which
    is what lets the sort's kernels return at once."""
    _, _, scene, cam = mixed
    cfg = RenderConfig(width=16, height=16, num_samples=4, max_bounces=5,
                       num_working_paths=POOL, sort_every=2)
    state = _synthetic_state(scene, cfg, 6, p_hit=0.97)
    words = _words(3)
    keys, bundle, counts = S.route_ref(scene, cfg, state, words)
    it, cam_start = torch.tensor(1), torch.tensor(300)
    assert not bool(S.cadence(counts, POOL, it, 2))
    g = np.random.default_rng(1)
    orders = (torch.sort(keys, stable=True).indices,
              torch.tensor(g.integers(-(1 << 40), 1 << 40, POOL)))
    outs = []
    fb0 = torch.zeros(cfg.num_pixels, 3)
    for order in orders:
        fb = fb0.clone()
        outs.append((S.shade_ref(scene, cam, cfg, state, fb, words, order,
                                 bundle, counts.clone(), it, cam_start, 2),
                     fb))
    monkeypatch.setattr(S, "_lib", _host_step())
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    for order in orders:
        fb = fb0.clone()
        outs.append((S.shade(scene, cam, cfg, _copy_state(state), fb, words,
                             order, bundle, counts.clone(), it, cam_start,
                             2), fb))
    (want, fb_want), *rest = outs
    for k, (got, fb) in enumerate(rest):
        plain = k == 0
        for f in ("pixel", "bounces", "trace_mask"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f in ("ray_o", "ray_d", "beta", "acc"):
            for x, y in zip(getattr(got, f), getattr(want, f)):
                if plain:
                    assert torch.equal(x, y), f
                else:   # the host's sqrt and division: as the step tests
                    torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6,
                                               equal_nan=True)
        assert torch.equal(got.counts, want.counts)
        assert torch.equal(fb, fb_want)


# ------------------------------------------------------- (d) CPU frames

_FRAMES = {"default": {}, "parity": dict(reference_parity=True),
           "wide": dict(wide=True), "unsorted": dict(sort_rays=False)}


@pytest.mark.parametrize("mode", list(_FRAMES))
def test_frame_launches_the_sort_once_a_sorted_iteration(monkeypatch,
                                                         mode):
    """A CPU frame of ``cornell_planes`` (12 triangles: ``sort_every``
    auto 2 on the default engine; a closed box, so most paths continue and
    the cadence skips) with the sort on the host-compiled passes launches
    it once an iteration of every sorted engine, the skips counted apart,
    and equals the frame of the plain sort bit for bit; the plain version
    counts one call an iteration; the unsorted engine sorts nothing."""
    scene, cam = cornell_planes("cpu")
    change = _narrow(monkeypatch, _FRAMES[mode])
    cfg = RenderConfig(width=8, height=8, num_samples=8, max_bounces=4,
                       num_working_paths=128, **change)
    assert S.engine_of(wf._step_mode(scene, cfg)) == mode

    def frame():
        SO.LAUNCHES["key_sort"] = SO.REF_CALLS["key_sort"] = 0
        return render_frame(scene, cam, cfg, torch.Generator().manual_seed(3))
    fb0, st0 = frame()
    its = st0["iterations"]
    sorted_ = mode != "unsorted"
    assert SO.REF_CALLS["key_sort"] == its * sorted_ and \
        SO.LAUNCHES["key_sort"] == 0
    _on_host(monkeypatch)
    before = SO.tally("cpu").clone()
    fb1, st1 = frame()
    assert st1["iterations"] == its and \
        st1["rays_traced"] == st0["rays_traced"]
    assert SO.LAUNCHES["key_sort"] == its * sorted_ and \
        SO.REF_CALLS["key_sort"] == 0
    # the tally is the device's: it also counts the steps a chunk runs
    # past the frame's end (render/wavefront.py STEPS_PER_READ), which
    # change nothing and sort (no path continues)
    full, skipped = (SO.tally("cpu") - before).tolist()
    assert its * sorted_ <= full + skipped < (its + wf.STEPS_PER_READ) * \
        sorted_ + 1
    assert (skipped > 0) == (mode == "default")
    assert torch.equal(fb0, fb1)


# ------------------------------------------- (e) checks and the library

@pytest.mark.parametrize("bad, error", [
    (torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.zeros(2, 3, dtype=torch.int32), ValueError),
    (torch.zeros(0, dtype=torch.int32), ValueError)], ids=str)
def test_wrapper_refuses_keys_the_kernels_do_not_take(monkeypatch, bad,
                                                      error):
    with pytest.raises(error):
        SO.stable_order(bad)
    _on_host(monkeypatch)
    with pytest.raises(error):
        SO.stable_order(bad)
    with pytest.raises(ValueError):
        SO.sort_into(torch.zeros(4, dtype=torch.int32),
                     torch.zeros(5, dtype=torch.int64))


def _exports(path):
    return sorted(set(re.findall(r'extern "C" \w+(?: \w+)? (rtjax_\w+)\(',
                                 path.read_text())))


def test_library_exports_the_entry_points_bind_binds():
    """csrc/key_sort.cu and its host stand-in export the same entry
    points, which ``sort.bind`` binds."""
    card = _exports(_build.SORT_SOURCE)
    host = _exports(Path(__file__).with_name("key_sort_host.cpp"))
    assert card == host == ["rtjax_key_sort", "rtjax_key_sort_kernel_info",
                            "rtjax_key_sort_scratch_bytes"]
    lib = _host_sort()
    assert lib.rtjax_key_sort.restype is ctypes.c_int


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 1 << 19])
def test_scratch_layout(n):
    """The scratch holds the zeroed counters (four passes' histograms of
    256 digits, four tickets, the status words of every pass, tile and
    digit) and two 16-byte aligned ping-pong arrays of n (key, index)
    pairs."""
    tiles = -(-n // 2048)
    counters = 4 * (4 * 256 + 4 + 4 * tiles * 256)
    total = _host_sort().rtjax_key_sort_scratch_bytes(n)
    assert total == -(-counters // 16) * 16 + 2 * (-(-8 * n // 16) * 16)
