"""The wavefront step as a captured CUDA graph: the port's counterpart of
rtjax's ``jax.jit`` of its frame loop (rtjax/render/wavefront.py:868).

rtjax compiles a whole frame into one device program.  Here one step of
the frame loop (``wavefront.frame_step``: ``wavefront_step`` gated on the
loop condition), followed by a ``copy_`` of its outputs back into a static
carry, is captured once with ``torch.cuda.graph``; ``render_frame_linear``
then replays it, ``STEPS_PER_READ`` replays between two reads of the
loop's condition.  A replay launches the step's ~1,600 kernels without the
host issuing them one by one.

- **The carry** is static: the path state, the framebuffer (accumulated in
  place, as the eager step does), ``cam_start``, ``it`` (a 0-d device
  tensor), the counters and the ``detailed_stats`` sums.
- **The random words** of each step are drawn by the host into a static
  ``[5, N]`` buffer before its replay (``rng.bits_block(out=)``), from the
  caller's generator in the eager loop's order: the words are the eager
  loop's, and the generator needs no registration with the graph.
- **Capture.**  The frame's first iteration runs eagerly on the capture
  stream and is the frame's own first step; it reaches every kernel the
  step launches at the shapes it launches them with, so the launch
  helpers' one-time work (``fetch_grid``'s shared-memory cap and
  occupancy query, ``csrc/fetch_walk.cuh``) is done before capture, and
  it makes the capture stream's work counter (``persist.work_buffer``)
  outside the graph's memory pool.  The step is then captured from its
  result; nothing runs twice.
- **The cache** holds one graph, keyed by the (scene, camera, config,
  ``step_kernels``, step-kernel design ``kernels.step.DESIGN``) that it
  was captured for, held strongly; a later frame of the same key
  resets the static carry and replays from its first step.
  :func:`clear_graphs` drops it.
- **Device loops.**  Repass's passes (render/trace.py) are rtjax's
  ``while_loop``: captured into CUDA-graph while nodes
  (render/device_loop.py), which a replay runs while a ray is pending.
- **Launch counts.**  The kernel wrappers count their launches in Python
  (``LAUNCHES`` of every kernel module), which a replay does not run;
  the launches counted while capturing are taken back, and each replay
  adds those outside the device loops once (kernels/counts.py).  A
  loop's body adds its launches once for every run of the body, read
  from the loop's device counter with the loop condition
  (:meth:`StepGraph.account`).
- **No fallback.**  Every mode's step is device-only, repass's passes
  too, so every mode comes here.  A step that reads the device from the
  host cannot be captured: the capture raises, and the frame is not
  rendered another way.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from ..core import rng
from ..kernels import counts, persist
from ..kernels import step as step_kernels_mod
from ..utils.log import logger
from . import device_loop
from . import wavefront as wf

_cache: list = []     # the one cached StepGraph
_streams: dict = {}   # device -> the capture stream


def clear_graphs() -> None:
    """Drop the cached graph (and the memory of its pools)."""
    while _cache:
        _cache.pop().drop()


def cached():
    """The cached :class:`StepGraph`, or None."""
    return _cache[0] if _cache else None


def flatten(carry) -> list:
    """The carry's tensors in a fixed order: the path state's fields (each
    vector component on its own), then the rest."""
    out = []
    for f in dataclasses.fields(carry[0]):
        v = getattr(carry[0], f.name)
        out.extend(v if isinstance(v, tuple) else (v,))
    return out + list(carry[1:])


def store(static, out) -> None:
    """Copy a step's outputs ``out`` into the carry ``static``, tensor by
    tensor (an output that is its static tensor is skipped: the
    framebuffer, and on the card the path state that the step kernels
    write in place).  Raises if an output differs in shape or dtype, or shares
    memory with the static carry: copying it would read a tensor already
    overwritten."""
    dst, src = flatten(static), flatten(out)
    held = {t.untyped_storage().data_ptr() for t in dst}
    if len(held) != len(dst):
        raise RuntimeError("two carry tensors share memory")
    for s, o in zip(dst, src, strict=True):
        if o is s:
            continue
        if o.shape != s.shape or o.dtype != s.dtype:
            raise RuntimeError(f"a step output ({tuple(o.shape)}, {o.dtype})"
                               f" does not fit its carry tensor "
                               f"({tuple(s.shape)}, {s.dtype})")
        if o.untyped_storage().data_ptr() in held:
            raise RuntimeError("a step output shares memory with the carry")
        s.copy_(o)


def _capture_stream(device) -> torch.cuda.Stream:
    s = _streams.get(device)
    if s is None:
        s = _streams[device] = torch.cuda.Stream(device)
    return s


class StepGraph:
    """One captured step and its static carry and word buffer."""

    graphed = True

    def __init__(self, scene, camera, cfg, carry, step_kernels=True):
        self.key = (scene, camera, cfg, step_kernels,
                    step_kernels_mod.DESIGN)
        self.carry = carry
        self.graph = None
        self.words = None
        self.launches = {}    # the step's launches outside device loops
        self.loops = None     # the step's device loops (Recorder)
        self._runs = []       # each loop's body runs as last read
        self.capture_s = 0.0  # this frame's seconds of capture
        self.pool_bytes = 0   # the graph pools' segments, in bytes

    def matches(self, scene, camera, cfg, step_kernels=True) -> bool:
        """Whether this graph was captured for these arguments under the
        step kernels' current design."""
        return (self.key[0] is scene and self.key[1] is camera
                and self.key[2] == cfg and self.key[3] == step_kernels
                and self.key[4] == step_kernels_mod.DESIGN)

    def reset(self, carry) -> None:
        """Start a frame from ``carry`` (a fresh frame's)."""
        for s, v in zip(flatten(self.carry), flatten(carry), strict=True):
            s.copy_(v)
        self.capture_s = 0.0

    def drop(self) -> None:
        """Free the graph, then the device loops' pool."""
        self.graph = None
        if self.loops is not None:
            self.loops.release()
            self.loops = None

    def _loops(self) -> list:
        return self.loops.loops if self.loops is not None else []

    def totals(self) -> torch.Tensor:
        """The device loops' body runs so far (int64 ``[loops]``), to be
        read with the loop condition and handed to :meth:`account`."""
        runs = [r for r, _ in self._loops()]
        if not runs:
            return torch.zeros(0, dtype=torch.int64,
                               device=self.carry[1].device)
        return torch.stack(runs)

    def account(self, runs) -> None:
        """Add each device loop's body launches once for every body run
        since the last read (``runs`` as :meth:`totals` gave them)."""
        for j, ((_, launches), now) in enumerate(zip(self._loops(), runs,
                                                     strict=True)):
            counts.add(launches, now - self._runs[j])
            self._runs[j] = now

    def step(self, generator) -> None:
        """One step: the eager first step and the capture when there is no
        graph yet, else the words drawn and one replay."""
        if self.graph is None:
            self._capture(generator)
            return
        rng.bits_block(generator, wf.NUM_RNG_WORDS, self.words.shape[1],
                       out=self.words)
        self.graph.replay()
        counts.add(self.launches)

    def _capture(self, generator) -> None:
        scene, camera, cfg, step_kernels, design = self.key
        if step_kernels_mod.DESIGN != design:
            raise RuntimeError(f"the step is captured under the {design!r} "
                               f"design, not {step_kernels_mod.DESIGN!r}")
        step = functools.partial(wf.frame_step, scene, camera, cfg,
                                 step_kernels=step_kernels)
        dev = self.carry[1].device
        stream = _capture_stream(dev)
        t0 = time.perf_counter()
        persist.work_buffer(dev, stream.cuda_stream)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            words = rng.bits_block(generator, wf.NUM_RNG_WORDS,
                                   cfg.pool_size)
            store(self.carry, step(words, self.carry))
            self.words = torch.empty_like(words)
        before = counts.snapshot()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()   # as the capture does; then the pool's
        reserved = torch.cuda.memory_reserved(dev)   # segments are new
        graph = torch.cuda.CUDAGraph()
        loops = device_loop.Recorder(dev)
        try:
            with loops.recording(), torch.cuda.graph(graph, stream=stream):
                store(self.carry, step(self.words, self.carry))
            # counted once while capturing: those outside the device loops
            # are launched by every replay, a loop's body by every run
            self.launches = counts.delta(before, counts.snapshot())
            for _, body in loops.loops:
                counts_sub(self.launches, body)
        except BaseException:
            loops.release()
            raise
        finally:
            counts.restore(before)
        torch.cuda.current_stream(dev).wait_stream(stream)
        loops.start()
        self.graph, self.loops = graph, loops
        self._runs = [0] * len(loops.loops)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
        logger.info(f"captured the wavefront step as a CUDA graph in "
                    f"{self.capture_s:.3f} s; graph pool "
                    f"{self.pool_bytes} bytes")


def counts_sub(launches: dict, body: dict) -> None:
    """Take a loop body's launches out of a step's (in place)."""
    for k, n in body.items():
        launches[k] -= n
        if launches[k] == 0:
            del launches[k]


def frame_steps(scene, camera, cfg, carry, step_kernels=True) -> StepGraph:
    """The :class:`StepGraph` of a frame starting from ``carry``: the
    cached one when it was captured for this (scene, camera, config,
    ``step_kernels``) under the step kernels' current design, else a new
    one (captured by its first step) that
    replaces it."""
    g = cached()
    if g is not None and g.matches(scene, camera, cfg, step_kernels):
        g.reset(carry)
        return g
    clear_graphs()
    g = StepGraph(scene, camera, cfg, carry, step_kernels)
    _cache.append(g)
    return g
