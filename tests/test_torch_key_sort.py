"""The step's stable key sort (rtjax_torch/kernels/sort.py), whose CUDA
kernels (csrc/key_sort.cu) run only on the card (tests/test_torch_cuda.py);
here their arithmetic (csrc/key_sort.cuh) compiled as host C++ and the
plain version.

(a) tests/key_sort_host.cpp runs the kernels' passes tile by tile with
    their tile and digit sizes, bound through the real wrapper: its
    permutation equals ``np.argsort(kind="stable")`` and the plain version
    on tools/sort_designs.py's key sets (constant keys, the dead classes,
    sorted, reversed, random 31-bit and int32 keys, the extremes, two
    keys, a late iteration's pool) at 1, 1000, one tile - 1, one tile, one
    tile + 1 and 2^17 - 3 keys; at 1, 2, 5 and 14 tiles the status words
    each tile published are every digit's count over it and the tiles
    before it; the first design (``stable_order_v1``) likewise.
(b) The plain version's permutation equals rtjax's ``lax.sort``
    (``sort_pytree_by_key``) on the keys of an rtjax step, for every
    ``sort_key``, with the dirty class; they are also route's keys.
(c) On a ``sort_every`` skip iteration a launch returns at once, the
    order as it was, and counts itself as such; shade (plain and compiled
    as host C++) gives the same state whatever the order holds; the if
    node's condition (``rtjax_key_sort_condition``) is kernels/step.py's
    ``cadence`` and counts itself in the tally; inside a capture with a
    recorder the wrapper launches the condition and then the kernels with
    no cadence, under the if node.
(d) A CPU frame through the compiled sort launches it once an iteration
    of every sorted path (the default engine with its cadence, parity, the
    wide bundle) and gives the plain sort's frame bit for bit; the plain
    version counts one call an iteration; the unsorted engine sorts
    nothing.
(e) The wrapper's input checks, the library's entry points against the
    host stand-in's, and the scratch's layout.
(f) The persistent scratch: consecutive launches at mixed sizes, each on
    its scratch as the launch before left it, each bit for bit; after each
    the tickets, the histogram planes and every status word as the next
    launch needs them (the counters wrapping every second launch, no word
    readable as published by the next).
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


def _macro(name):
    """A default of csrc/key_sort.cuh's build settings."""
    return int(re.search(rf"#define {name} (\d+)\n",
                         _build.SORT_HEADER.read_text()).group(1))


# a tile's keys in the engine's build (kTile: kBlock x kItems) and an
# upsweep block's (kBlock x kUpItems)
TILE = 256 * _macro("RTJAX_SORT_ITEMS")
UP_KEYS = 256 * _macro("RTJAX_SORT_UP_ITEMS")


def _host_sort(defines=None):
    """csrc/key_sort.cuh compiled as host C++ with the kernels' launch
    logic (tests/key_sort_host.cpp), bound as the sort's library; with
    ``defines`` ({macro: value}) built with other settings."""
    src = Path(__file__).with_name("key_sort_host.cpp")
    tag = "".join(f"_{k[11:].lower()}{v}" for k, v in (defines or {}).items())
    out = _build._build(
        _build.BUILD_DIR / f"libkey_sort_host{tag}.so", [src],
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         f"-I{_build.CSRC_DIR}"]
        + [f"-D{k}={v}" for k, v in (defines or {}).items()],
        (_build.SORT_HEADER,))
    return SO.bind(ctypes.CDLL(str(out)))


def _on_host(monkeypatch, defines=None):
    """The sort's card path on CPU tensors, over the host-compiled
    library (fresh persistent scratches)."""
    monkeypatch.setattr(SO, "_lib", _host_sort(defines))
    monkeypatch.setattr(SO, "_scratches", {})
    monkeypatch.setattr(SO, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))


# ------------------------------------------- (a) the passes on the host

def _size(name):
    return {"1": 1, "1000": 1000, "tile-1": TILE - 1, "tile": TILE,
            "tile+1": TILE + 1, "2^17-3": (1 << 17) - 3}[name]


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


def _layout(n, tile=TILE):
    """The persistent scratch's layout (csrc/key_sort.cuh ``layout``) in
    32-bit words: ``(counters, hist, status, tiles)``, the status words
    ``[4 passes, tiles, 256]``."""
    return 0, 8, 8 + 2 * 4 * 256, -(-n // tile)


def _scratch_words(space, n, tile=TILE):
    """The scratch's counters ``[8]``, histogram planes ``[2, 4, 256]``
    and status words ``[4, tiles, 256]`` as int64 arrays."""
    c, h, st, tiles = _layout(n, tile)
    w = space[:(st + 4 * tiles * 256) * 4].view(torch.int32).numpy()
    w = w.astype(np.int64) & 0xFFFFFFFF
    return (w[c:h], w[h:st].reshape(2, 4, 256),
            w[st:].reshape(4, tiles, 256))


def _check_after_launch(space, keys, launches, tile=TILE):
    """The scratch after the ``launches``-th launch on it (1 the first):
    the tickets at the next launch's start, the histogram plane of this
    launch's parity each pass's digit counts and the other plane zero,
    every status word a prefix of this launch (each tile's count of the
    digit over the tiles up to it, in the order the pass ranks its keys),
    none readable as published by the next launch."""
    n = keys.shape[0]
    parity = (launches - 1) % 2
    counters, hist, status = _scratch_words(space, n, tile)
    tiles = status.shape[1]
    nxt = launches % 2
    assert counters[0] == nxt * -(-n // UP_KEYS)   # the upsweep's blocks
    assert list(counters[1:5]) == [nxt * tiles] * 4
    u = (keys.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    d = np.stack([(u >> (8 * p)) & 0xFF for p in range(4)])
    want = np.stack([np.bincount(d[p], minlength=256) for p in range(4)])
    np.testing.assert_array_equal(hist[parity], want)
    assert not hist[1 - parity].any()
    # pass p ranks the keys in the order of the passes before it
    per_tile = np.zeros((4, tiles, 256), np.int64)
    for p in range(4):
        seen = np.argsort(u & ((1 << (8 * p)) - 1), kind="stable")
        np.add.at(per_tile[p], (np.arange(n) // tile, d[p][seen]), 1)
    tag = 0 if parity else 1   # csrc/key_sort.cuh status_tag
    np.testing.assert_array_equal(status >> 31, tag)
    np.testing.assert_array_equal((status >> 30) & 1, 1)
    np.testing.assert_array_equal(status & ((1 << 30) - 1),
                                  np.cumsum(per_tile, axis=1))


@pytest.mark.parametrize("tiles", [1, 2, 5, 14])
@pytest.mark.parametrize("keyset", SD.SETS)
def test_host_lookback_prefixes(monkeypatch, keyset, tiles):
    """At 1, 2, 5 and 14 tiles (the last one partial): the order is the
    stable argsort, each pass's histogram its digits' counts, and each
    tile's status words, published and resolved by the look-back, every
    digit's count over it and the tiles before it."""
    n = tiles * TILE - 5
    keys = SD.synthetic_keys(keyset, n, seed=tiles)
    _on_host(monkeypatch)
    got = SO.stable_order(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(keys, kind="stable"))
    _check_after_launch(SO.scratch("cpu", n), keys, 1)


@pytest.mark.parametrize("keyset", SD.SETS)
def test_host_first_design_equals_a_stable_argsort(monkeypatch, keyset):
    """the first design (``stable_order_v1``: a fresh scratch zeroed by its
    launch, a look-back a tile), run by its host stand-in, gives the
    stable permutation; on a CPU tensor without the stand-in the plain
    version."""
    n = 3 * TILE + 5
    keys = SD.synthetic_keys(keyset, n, seed=7)
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(
        SO.stable_order_v1(torch.from_numpy(keys)).numpy(), want)
    _on_host(monkeypatch)
    before = SO.LAUNCHES["key_sort_v1"]
    got = SO.stable_order_v1(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), want)
    assert SO.LAUNCHES["key_sort_v1"] == before + 1


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


@pytest.mark.parametrize("sort_every", [1, 2, 3])
@pytest.mark.parametrize("it", [0, 1, 2, 5, "tensor 4", -1])
@pytest.mark.parametrize("live", ["all", "3/4", "3/4 - 1"])
def test_if_condition_equals_the_cadence(sort_every, it, live):
    """The if node's condition kernel (its host stand-in writes the
    condition where the handle points) is kernels/step.py's ``cadence``
    (every iteration without one) and counts the launch in the tally as
    sorted or skipped."""
    lib = _host_sort()
    n = 4000
    counts = torch.tensor([{"all": n, "3/4": 3 * n // 4,
                            "3/4 - 1": 3 * n // 4 - 1}[live], 0, 0, 0, 0])
    i = torch.tensor(4) if it == "tensor 4" else it
    flag = torch.full((1,), 7, dtype=torch.int32)
    tally = torch.zeros(2, dtype=torch.int64)
    rc = lib.rtjax_key_sort_condition(
        flag.data_ptr(), counts.data_ptr(),
        i.data_ptr() if torch.is_tensor(i) else None,
        0 if torch.is_tensor(i) else i, sort_every, n, tally.data_ptr(),
        None)
    assert rc == 0
    c = S.cadence(counts, n, i, sort_every)
    sorts = True if c is None else bool(c)
    assert flag.item() == int(sorts)
    assert tally.tolist() == ([1, 0] if sorts else [0, 1])


class _Recorder:
    """A stand-in of ``device_loop.Recorder`` for the branch: its handle
    is the address of a CPU word, which the condition's host stand-in
    sets, and the body runs where it was captured."""

    def __init__(self):
        self.flag = torch.zeros(1, dtype=torch.int32)
        self.calls = []

    def branch(self, set_condition):
        self.calls.append("condition")
        set_condition(self.flag.data_ptr())
        self.calls.append("if node")
        yield True
        self.calls.append("end")


@pytest.mark.parametrize("it", [1, 2])
def test_captured_sort_goes_under_an_if_node(monkeypatch, it):
    """Inside a capture with a recorder, a launch with a cadence sets the
    if node's condition (counted in the tally, skip or not) and captures
    the kernels' launch into the node's body with no cadence, so that the
    body sorts wherever a replay runs it; the wrapper counts one launch."""
    from rtjax_torch.render import device_loop
    _on_host(monkeypatch)
    rec = _Recorder()
    monkeypatch.setattr(device_loop, "_recorder", rec)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    n = 3000
    keys = torch.from_numpy(SD.synthetic_keys("random31", n, 4))
    counts = torch.tensor([n, 0, 0, 0, 0])
    before, launches = SO.tally("cpu").clone(), SO.LAUNCHES["key_sort"]
    out = torch.full((n,), -7, dtype=torch.int64)
    got = SO.sort_into(keys, out, (counts, torch.tensor(it), 2))
    assert rec.calls == ["condition", "if node", "end"]
    assert rec.flag.item() == (it % 2 == 0)
    assert (SO.tally("cpu") - before).tolist() == ([1, 0] if it % 2 == 0
                                                   else [0, 1])
    assert got is out and torch.equal(got, torch.sort(keys,
                                                      stable=True).indices)
    assert SO.LAUNCHES["key_sort"] == launches + 1


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
    assert card == host == ["rtjax_key_sort", "rtjax_key_sort_condition",
                            "rtjax_key_sort_kernel_info",
                            "rtjax_key_sort_scratch_bytes",
                            "rtjax_key_sort_v1",
                            "rtjax_key_sort_v1_scratch_bytes"]
    lib = _host_sort()
    assert lib.rtjax_key_sort.restype is ctypes.c_int


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 4 * 2048 + 1, 1 << 19])
def test_scratch_layout(n):
    """The persistent scratch holds eight counters (the upsweep's ticket
    and each pass's), two planes of the four passes' histograms of 256
    digits, the status words of every pass, tile and digit, and two
    16-byte aligned ping-pong arrays of n (key, index) pairs; the first
    design's fresh one its zeroed counters (a histogram a pass, four
    tickets, the status words of every pass, tile and digit) and the same
    pairs."""
    pairs = 2 * (-(-8 * n // 16) * 16)
    tiles = -(-n // 2048)
    words = 8 + 2 * 4 * 256 + 4 * tiles * 256
    lib = _host_sort()
    assert lib.rtjax_key_sort_scratch_bytes(n) == \
        -(-4 * words // 16) * 16 + pairs
    counters = 4 * (4 * 256 + 4 + 4 * tiles * 256)
    assert lib.rtjax_key_sort_v1_scratch_bytes(n) == \
        -(-counters // 16) * 16 + pairs


# -------------------------------------------- (f) the persistent scratch

@pytest.mark.parametrize("sizes", ["one size", "two sizes", "three sizes"])
def test_consecutive_launches_share_the_scratch(monkeypatch, sizes):
    """Launches in turn at mixed sizes, each on its size's persistent
    scratch as the launch before left it (never zeroed between), each bit
    for bit the stable argsort; after each, the scratch as the next launch
    of its size needs it (:func:`_check_after_launch`)."""
    _on_host(monkeypatch)
    ns = {"one size": [5 * TILE + 9],
          "two sizes": [3 * TILE - 1, 9 * TILE + 77],
          "three sizes": [1000, TILE + 1, 6 * TILE]}[sizes]
    made = {}
    for k, keyset in enumerate(SD.SETS):
        n = ns[k % len(ns)]
        keys = SD.synthetic_keys(keyset, n, seed=k)
        got = SO.stable_order(torch.from_numpy(keys))
        np.testing.assert_array_equal(got.numpy(),
                                      np.argsort(keys, kind="stable"))
        made[n] = made.get(n, 0) + 1
        _check_after_launch(SO.scratch("cpu", n), keys, made[n])
    assert sorted(k[1] for k in SO._scratches) == sorted(ns)


@pytest.mark.parametrize("keyset", ["random_int32", "all_equal"])
def test_sequence_counter_wraps(monkeypatch, keyset):
    """The tickets run over two launches' worth and wrap: across five
    launches on one scratch the counters go 0 -> count -> 0 -> ..., the
    parity alternates, skips take no ticket, and every launch after a
    wrap still sorts bit for bit."""
    _on_host(monkeypatch)
    n = 4 * TILE + 3
    space = SO.scratch("cpu", n)
    counts = torch.tensor([n, 0, 0, 0, 0])
    tiles = _layout(n)[3]
    for launch in range(1, 6):
        keys = SD.synthetic_keys(keyset, n, seed=launch)
        out = torch.full((n,), -7, dtype=torch.int64)
        SO.sort_into(torch.from_numpy(keys), out, (counts, 1, 2))   # skip
        assert (out == -7).all()
        got = SO.stable_order(torch.from_numpy(keys))
        np.testing.assert_array_equal(got.numpy(),
                                      np.argsort(keys, kind="stable"))
        counters = _scratch_words(space, n)[0]
        assert list(counters[1:5]) == [(launch % 2) * tiles] * 4
        _check_after_launch(space, keys, launch)
