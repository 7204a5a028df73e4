#!/usr/bin/env python3
"""Repass's passes inside the captured step, two designs, on one CUDA card.

    python3 tools/repass_designs.py [--n-inst 16,64] [--reps 2]

Repass (render/trace.py) walks one candidate instance of every pending
ray a pass, at most G passes for a mesh of G instances.  Inside the
captured step the passes are a device loop (render/device_loop.py):

- ``while``, the engine's: one CUDA-graph while node a mesh group and
  channel, whose body runs while a ray is pending;
- ``masked``: all G passes captured, each masked on the device by its
  pending rays, a pass after the last candidate running its ops and its
  launch over an empty mask (``device_loop.passes`` rebound here to its
  op-by-op form, which the eager loop runs).

On eval config 4's cell (256x256 @ 8 spp, 5 bounces; the scene
``scenes.instanced_bunnies(n_inst=...)``, 16 being config 4) it renders
the eager loop's frames (``graph=False``, the reference), then each design
captured in turns (masked, while, while, masked; the graph cache cleared
and the step captured from seed 1 for each), every frame checked against
the eager one of its seed (equal iterations, rays and occupancy,
framebuffers within rtol 1e-5), then arm (b) (``two_level="kernel"``)
captured.  Every frame's seconds and synchronising calls (torch.cuda's
sync debug mode) are printed, with the medians.  Beside them:

- the census: one eager frame with render/trace.py's ``_backend``
  wrapped, so that every pass's launch reads whether its mask holds a ray
  (this script's reads, not the engine's): busy and idle passes a frame,
  per channel;
- an idle pass's device time: a graph of ``trace_closest`` (then
  ``trace_anyhit``) over a pool of inactive rays under the masked design
  (the base launch and G idle passes) against a graph of the base launch
  alone, each replayed between CUDA events; an idle pass is their
  difference over G.  Idle passes x that time is what the masked design
  spends that the while nodes do not.

:func:`run` is also called by ``chip_smoke.py``'s phase 13.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FB_RTOL, FB_ATOL = 1e-5, 1e-7
ORDER = ("masked", "while", "while", "masked")
REPLAYS = 20


def _masked_passes(pend, n):
    """Design (i): every pass, masked, captured or not."""
    for _ in range(n):
        yield


@contextlib.contextmanager
def design(name):
    """Run the block under design ``name`` ("while" or "masked")."""
    from rtjax_torch.render import device_loop
    shipped = device_loop.passes
    if name == "masked":
        device_loop.passes = _masked_passes
    try:
        yield
    finally:
        device_loop.passes = shipped


def _frame(scene, cam, cfg, seed, graph):
    """``(seconds, framebuffer, stats, synchronising calls)``."""
    import torch
    from rtjax_torch.render.wavefront import render_frame
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            fb, st = render_frame(scene, cam, cfg, gen, graph=graph)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = sum("synchroniz" in str(w.message).lower() for w in seen)
    return secs, fb, st, reads


def census(scene, cam, cfg, seed=2):
    """Busy and idle passes of one eager frame, per channel:
    ``{"closest": [busy, idle], "anyhit": [busy, idle]}``."""
    import torch
    from rtjax_torch.render import trace
    blas = {id(b) for b in scene.blas}
    out = {"closest": [0, 0], "anyhit": [0, 0]}
    backend = trace._backend

    def counted(mesh, cfg_, with_stats=False):
        fns = backend(mesh, cfg_, with_stats)
        if id(mesh) not in blas:
            return fns

        def wrap(kind, fn, mask_at):
            def call(*args, **kw):
                out[kind][0 if bool(args[mask_at].any()) else 1] += 1
                return fn(*args, **kw)
            return call
        return wrap("closest", fns[0], 3), wrap("anyhit", fns[1], 4)

    trace._backend = counted
    try:
        _frame(scene, cam, cfg, seed, False)
    finally:
        trace._backend = backend
    torch.cuda.synchronize()
    return out


def _graph_ms(fn):
    """Device time (ms) of one replay of a graph of ``fn()``: captured on
    a side stream after one eager call, replayed REPLAYS times between two
    CUDA events."""
    import torch
    from rtjax_torch.kernels import persist
    s = torch.cuda.Stream()
    persist.work_buffer(torch.device("cuda"), s.cuda_stream)
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(REPLAYS):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPLAYS


def idle_pass_ms(scene, cfg):
    """``{channel: (call ms, base ms, idle pass ms)}`` over a pool of
    ``cfg.pool_size`` inactive rays, under the masked design."""
    import torch
    from rtjax_torch.render import trace
    n = cfg.pool_size
    o = tuple(torch.full((n,), v, device="cuda") for v in (0.0, 1.0, 3.0))
    d = tuple(torch.full((n,), v, device="cuda") for v in (0.0, -0.3, -1.0))
    tmax = torch.full((n,), float("inf"), device="cuda")
    off = torch.zeros(n, dtype=torch.bool, device="cuda")
    excl = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    g = sum(grp.size for grp in scene.instances.groups)
    base = trace._backend(scene, cfg)
    res = {}
    with design("masked"):
        for kind, call, alone in (
                ("closest", lambda: trace.trace_closest(scene, cfg, o, d,
                                                        tmax, off),
                 lambda: base[0](o, d, tmax, off)),
                ("anyhit", lambda: trace.trace_anyhit(scene, cfg, o, d, tmax,
                                                      excl, off),
                 lambda: base[1](o, d, tmax, excl, off))):
            whole, first = _graph_ms(call), _graph_ms(alone)
            res[kind] = (whole, first, (whole - first) / g)
    return res


def run(n_insts=(16, 64), reps=2, log=print):
    """Both designs on each scene: ``{n_inst: {"census", "idle_ms",
    "idle_frame_ms", "eager", "masked", "while", "kernel"}}``, the frame
    lists of ``(seconds, synchronising calls, iterations)``; raises if a
    captured frame differs from the eager one of its seed."""
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.render import graph as G
    from rtjax_torch.scenes import instanced_bunnies
    cfg = RenderConfig(width=256, height=256, num_samples=8, max_bounces=5)
    k_cfg = RenderConfig(width=256, height=256, num_samples=8, max_bounces=5,
                         two_level="kernel")
    seeds = tuple(range(2, 2 + reps))
    out = {}
    for n in n_insts:
        scene, cam = instanced_bunnies("cuda", n_inst=n)
        rec = {"census": census(scene, cam, cfg),
               "idle_ms": idle_pass_ms(scene, cfg)}
        eager = {s: _frame(scene, cam, cfg, s, False) for s in seeds}
        rec["eager"] = [(f[0], f[3], f[2]["iterations"])
                        for f in eager.values()]
        for name in ORDER:
            with design(name):
                G.clear_graphs()
                _frame(scene, cam, cfg, 1, True)      # the capture
                for s in seeds:
                    f = _frame(scene, cam, cfg, s, True)
                    e = eager[s]
                    same = f[2]["graphed"] and all(
                        f[2][k] == e[2][k] for k in
                        ("iterations", "rays_traced", "avg_occupancy"))
                    if not same or not torch.allclose(
                            f[1], e[1], rtol=FB_RTOL, atol=FB_ATOL):
                        raise RuntimeError(f"{n} instances, {name}, seed "
                                           f"{s}: the graph frame differs "
                                           "from the eager one")
                    rec.setdefault(name, []).append(
                        (f[0], f[3], f[2]["iterations"]))
        G.clear_graphs()
        _frame(scene, cam, k_cfg, 1, True)
        rec["kernel"] = [(f[0], f[3], f[2]["iterations"]) for f in
                         (_frame(scene, cam, k_cfg, s, True) for s in seeds)]
        G.clear_graphs()
        idle = rec["idle_ms"]
        rec["idle_frame_ms"] = sum(rec["census"][k][1] * idle[k][2]
                                   for k in ("closest", "anyhit"))
        med = {k: statistics.median(v[0] for v in rec[k])
               for k in ("eager", "masked", "while", "kernel")}
        rec["medians"] = med
        log(f"[repass designs {n} instances] passes a frame (busy, idle): "
            f"closest {rec['census']['closest']}, any hit "
            f"{rec['census']['anyhit']}; an idle masked pass "
            + ", ".join(f"{k} {v[2]:.4f} ms" for k, v in idle.items())
            + f"; the masked design's idle passes "
            f"{rec['idle_frame_ms']:.2f} ms a frame")
        log(f"[repass designs {n} instances] frame seconds: "
            + "; ".join(f"{k} {[round(v[0], 4) for v in rec[k]]} (median "
                        f"{med[k]:.4f}, synchronising calls "
                        f"{[v[1] for v in rec[k]]})"
                        for k in ("eager", "masked", "while", "kernel"))
            + f"; iterations {rec['while'][0][2]}; masked / while "
            f"{med['masked'] / med['while']:.3f}")
        out[n] = rec
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-inst", default="16,64")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("repass_designs: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    run(tuple(int(x) for x in args.n_inst.split(",")), args.reps)


if __name__ == "__main__":
    main()
