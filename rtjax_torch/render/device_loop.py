"""rtjax's ``jax.lax.while_loop`` and ``lax.cond`` with a device
condition, inside the captured wavefront step (render/graph.py): the loop
of repass's passes (render/trace.py), rtjax/render/trace.py:403-434 and
473-496, and the branch around the key sort on the ``sort_every`` cadence
(kernels/sort.py), rtjax/render/wavefront.py:396-401.

:func:`passes` drives up to ``n`` passes of a loop whose condition is the
device bool ``pend.any()``; the caller's body updates its state, ``pend``
included, in place.

- **On the CPU** it is rtjax's loop: ``pend.any()`` is read before each
  pass and the loop stops when it is false, so it launches what rtjax
  launches (a host read costs nothing there).
- **On the card outside a capture** (``graph=False``, the frame's first,
  eager step) it runs the body ``n`` times.  A pass with no pending ray
  changes nothing, and ``n`` is rtjax's bound, so the results are those of
  rtjax's loop, with no host read.
- **Inside a capture with a** :class:`Recorder` (render/graph.py makes one
  for every capture) the body is captured once, on the recorder's body
  stream, into a CUDA-graph while node (``csrc/graph_loop.cu``, CUDA >=
  12.4; PyTorch has no Python API for it in the installed version): a
  replay runs the body while ``pend.any()`` holds, at most ``n`` times,
  as rtjax's ``while_loop`` does, and skips the passes that would find no
  pending ray.  The bodies' temporaries come from a memory pool of the
  recorder's own, which lives as long as the graph.
- **Branches.**  :func:`branch` runs a body once.  Inside a capture with a
  :class:`Recorder` the caller's kernel sets the condition of a
  CUDA-graph if node (the key sort's ``cadence_condition``) and the body
  is captured on the body stream into the node's body, which a replay
  runs where the condition is set; elsewhere the body runs as it is and
  decides on its own.  The body's launches count once a replay, as the
  step's do: which replays ran it, the caller counts on the device.
- **Launch counts.**  A body's kernels are counted once while it is
  captured; the recorder keeps each loop's count apart, with a device
  counter of the body's runs over every replay (``Recorder.loops``), and
  render/graph.py adds runs x count when it reads the counters with the
  loop condition.  So the counts stay the launches that ran.

A failed launch of the loop's kernels raises; there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from ..kernels import _build, counts, persist

_lock = threading.Lock()
_lib = None
_recorder = None   # the Recorder of the capture under way


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.loop_library()))
            P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
            lib.rtjax_loop_begin.argtypes = [P, P, P, P, P, I,
                                             ctypes.POINTER(U)]
            lib.rtjax_loop_end.argtypes = [P, U, P, P, P, I]
            lib.rtjax_loop_stream.argtypes = [ctypes.POINTER(P)]
            lib.rtjax_cond_handle.argtypes = [P, ctypes.POINTER(U)]
            lib.rtjax_if_begin.argtypes = [P, P, U]
            lib.rtjax_if_end.argtypes = [P]
            for f in (lib.rtjax_loop_begin, lib.rtjax_loop_end,
                      lib.rtjax_loop_stream, lib.rtjax_cond_handle,
                      lib.rtjax_if_begin, lib.rtjax_if_end):
                f.restype = I
            _lib = lib
        return _lib


_body_streams: dict = {}   # device index -> the loop bodies' stream


def body_stream(device) -> torch.cuda.ExternalStream:
    """The stream the loop bodies of captures on ``device`` are captured
    from: one a device, made by ``csrc/graph_loop.cu`` (a stream from
    PyTorch's pool may be the capture's own), with its work counter for
    the persist kernels made outside any graph."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with _lock:
        s = _body_streams.get(index)
    if s is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(index):
            _raise_on(_kernels().rtjax_loop_stream(ctypes.byref(handle)),
                      "stream")
        dev = torch.device("cuda", index)
        s = torch.cuda.ExternalStream(handle.value, device=dev)
        persist.work_buffer(dev, s.cuda_stream)
        with _lock:
            s = _body_streams.setdefault(index, s)
    return s


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"device loop {what} failed: CUDA error {rc}")


# the device loops one capture may hold (two a mesh group and step)
MAX_LOOPS = 4096


class Recorder:
    """The device loops of one capture on ``device``: the body stream
    (:func:`body_stream`), the bodies' memory pool, a scratch iteration
    count, and per loop ``(runs, launches)``: a 0-d int64 device counter
    of its body's runs and the kernel launches counted while its body was
    captured.  The
    counters outlive a replay, so they are made here, outside the graph's
    pool, whose memory earlier nodes of every replay may write."""

    def __init__(self, device):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.body_stream = body_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.k = torch.zeros((), dtype=torch.int32, device=self.device)
        self.runs = torch.zeros(MAX_LOOPS, dtype=torch.int64,
                                device=self.device)
        self.loops: list = []

    @contextlib.contextmanager
    def recording(self):
        """Let :func:`passes` capture loops while the block runs (the
        body stream allocating from the recorder's pool)."""
        global _recorder
        index = self.device.index
        with torch.cuda.stream(self.body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, self.pool)
        _recorder = self
        try:
            yield self
        finally:
            _recorder = None
            torch._C._cuda_endAllocateToPool(index, self.pool)

    def release(self) -> None:
        """Give the bodies' pool back (once the graph is gone)."""
        torch._C._cuda_releasePool(self.device.index, self.pool)

    def start(self) -> None:
        """Zero the loops' run counters (after the capture)."""
        self.runs.zero_()

    def loop(self, pend, n: int):
        """Capture one while node: yields once, the caller capturing the
        body on the body stream."""
        lib = _kernels()
        dev = self.device
        stream = torch.cuda.current_stream(dev)
        body = self.body_stream
        if len(self.loops) == MAX_LOOPS:
            raise RuntimeError(f"a captured step holds at most {MAX_LOOPS} "
                               "device loops")
        runs = self.runs[len(self.loops)]
        handle = ctypes.c_ulonglong()
        pred = pend.any()
        _raise_on(lib.rtjax_loop_begin(
            stream.cuda_stream, body.cuda_stream, pred.data_ptr(),
            self.k.data_ptr(), runs.data_ptr(), n, ctypes.byref(handle)),
            "capture")
        before = counts.snapshot()
        with torch.cuda.stream(body):
            yield
            pred = pend.any()
            _raise_on(lib.rtjax_loop_end(
                body.cuda_stream, handle.value, pred.data_ptr(),
                self.k.data_ptr(), runs.data_ptr(), n), "capture")
        self.loops.append((runs, counts.delta(before, counts.snapshot())))

    def branch(self, set_condition):
        """Capture one if node: ``set_condition(handle)`` launches the
        kernel that sets its condition; yields True once, the caller
        capturing the body on the body stream."""
        lib = _kernels()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        body = self.body_stream
        handle = ctypes.c_ulonglong()
        _raise_on(lib.rtjax_cond_handle(stream, ctypes.byref(handle)),
                  "capture")
        set_condition(handle.value)
        _raise_on(lib.rtjax_if_begin(stream, body.cuda_stream, handle.value),
                  "capture")
        with torch.cuda.stream(body):
            yield True
            _raise_on(lib.rtjax_if_end(body.cuda_stream), "capture")


def _on_card(pend) -> bool:
    """Whether ``pend`` lies on the card, where reading it from the host
    would cost a synchronisation (tests stand in for the card here)."""
    return pend.is_cuda


def passes(pend, n: int):
    """Up to ``n`` passes while the device bool ``pend.any()`` holds: a
    generator over the passes (see the module docstring)."""
    if not _on_card(pend):
        for _ in range(n):
            if not bool(pend.any()):
                return
            yield
        return
    rec = _recorder
    if rec is None or not torch.cuda.is_current_stream_capturing():
        for _ in range(n):
            yield
        return
    yield from rec.loop(pend, n)


def branch(set_condition):
    """A body run once (see the module docstring): a generator that yields
    once, True where the body is captured into an if node whose condition
    ``set_condition(handle)`` sets on the device, False where the body runs
    as it is and must decide on its own."""
    rec = _recorder
    if rec is None or not torch.cuda.is_current_stream_capturing():
        yield False
        return
    yield from rec.branch(set_condition)
