"""The step's stable key sort: the wrapper of the hand-written CUDA radix
sort and its plain PyTorch version.

rtjax sorts the pool once an iteration by one ``lax.sort(..., num_keys=1,
is_stable=True)`` (rtjax/render/sorting.py:126 ``sort_pytree_by_key``,
:152), called at rtjax/render/wavefront.py:361 (``reference_parity``),
:396-401 (the compact bundle, under ``lax.cond(do_gen, ...)`` when
``k_sort > 1``) and :424 (the wide bundle).  The port's fused step
(render/wavefront.py ``_fused_step``) takes the permutation of the keys
route wrote, here, and shade gathers the lanes' records by it.

:func:`stable_order` ``(keys, cadence=None) -> order``: ``keys`` an
``[N]`` int32 tensor (any value, negative ones included; N >= 1),
``order`` the ``[N]`` int64 stable ascending permutation, which equals
``torch.sort(keys, stable=True).indices``.  ``cadence`` is the default
engine's ``(counts, it, sort_every)``: route's counts (``counts[0]`` the
continuing paths), the iteration (an int or a 0-d int64 tensor) and
``sort_every``.  Where the iteration does not sort (``counts[0] * 4 >=
3N`` and ``it % sort_every != 0``; kernels/step.py ``cadence``) the
kernels return at once and leave ``order`` as it is: shade reads the
identity then.

A CUDA tensor goes to the kernels (``csrc/key_sort.cu``, its arithmetic
``csrc/key_sort.cuh``; built at first use, bound with ctypes, launched on
torch's current stream, so that a captured graph holds them): a memset of
the scratch's counters, one upsweep kernel (every pass's digit
histograms and offsets) and one kernel for each of the four 8-bit digit
passes.  A CPU tensor goes to the plain
version, ``torch.sort(keys, stable=True).indices``, which on the card is
only the yardstick.  There is no fallback between them.

The scratch (histograms, tickets, look-back status words, the ping-pong
(key, int32 index) pairs) is allocated by the wrapper with ``torch.empty``,
so that a captured graph's pool holds it; the launch zeroes what must
start at zero inside its own nodes.

Counts: ``LAUNCHES["key_sort"]`` one a wrapper launch, ``REF_CALLS`` one
a plain call; on the card :func:`tally` counts on the device the launches
that sorted and those that returned at once (a captured graph's replays
included).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

MAX_KEYS = (1 << 30) - 1   # the look-back's 30-bit counts

LAUNCHES = {"key_sort": 0}
REF_CALLS = {"key_sort": 0}

# kernel ids of ``rtjax_key_sort_kernel_info``
KERNEL_IDS = {"upsweep": 0, "pass": 1}

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lock = threading.Lock()
_lib = None
_tallies: dict = {}


def stable_order_ref(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`stable_order` (any device; it
    sorts on every iteration: shade selects the identity on a skip)."""
    REF_CALLS["key_sort"] += 1
    return torch.sort(keys, stable=True).indices


def bind(lib):
    """Set the argument types of a key-sort library's entry points
    (``ctypes.CDLL``) and return it."""
    lib.rtjax_key_sort.argtypes = [_P, _P, _P, _I32, _P, _P, _I64, _I32, _P,
                                   _P]
    lib.rtjax_key_sort.restype = _I32
    lib.rtjax_key_sort_scratch_bytes.argtypes = [_I32]
    lib.rtjax_key_sort_scratch_bytes.restype = _I64
    lib.rtjax_key_sort_kernel_info.argtypes = ([_I32]
                                               + [ctypes.POINTER(_I32)] * 4)
    lib.rtjax_key_sort_kernel_info.restype = _I32
    return lib


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(_build.key_sort_library())))
        return _lib


def _on_card(t) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    version); other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def scratch_bytes(n: int) -> int:
    """Bytes of scratch a sort of ``n`` keys takes."""
    return int(_kernels().rtjax_key_sort_scratch_bytes(n))


def tally(device) -> torch.Tensor:
    """The device's int64 ``[2]`` count of kernel sorts: the launches that
    sorted and those that returned at once (the cadence's skips), added
    on the device since the process began (read it before and after)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        t = _tallies.get(str(device))
        if t is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                # made inside a capture it would be the graph's and zeroed
                # by every replay: a frame's eager first step makes it
                raise RuntimeError("the sort's tally is made outside a "
                                   "CUDA-graph capture")
            t = _tallies[str(device)] = torch.zeros(2, dtype=torch.int64,
                                                    device=device)
    return t


def kernel_info(name) -> dict:
    """A sort kernel's registers, local (spill) bytes a thread, threads a
    block and resident blocks an SM at that block, by :data:`KERNEL_IDS`
    name."""
    vals = [_I32() for _ in range(4)]
    rc = _kernels().rtjax_key_sort_kernel_info(KERNEL_IDS[name],
                                               *map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"key sort kernel info of {name} failed: CUDA "
                           f"error {rc}")
    regs, local, block, blocks = (v.value for v in vals)
    return dict(registers=regs, local_bytes=local, block=block,
                blocks_per_sm=blocks, warps_per_sm=blocks * block // 32)


def _check(keys):
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if keys.dim() != 1 or keys.shape[0] < 1:
        raise ValueError(f"keys must have shape [N], N >= 1, got "
                         f"{tuple(keys.shape)}")
    if keys.shape[0] > MAX_KEYS:
        raise ValueError(f"{keys.shape[0]} keys: the sort takes at most "
                         f"{MAX_KEYS}")


def stable_order(keys: torch.Tensor, cadence=None) -> torch.Tensor:
    """The stable ascending order of ``keys`` (module docstring)."""
    _check(keys)
    if not _on_card(keys):
        return stable_order_ref(keys)
    order = torch.empty(keys.shape[0], dtype=torch.int64, device=keys.device)
    return sort_into(keys, order, cadence)


def sort_into(keys: torch.Tensor, order: torch.Tensor, cadence=None):
    """The kernels' launch of :func:`stable_order` writing into ``order``
    (an ``[N]`` int64 tensor on the keys' card), which a skip iteration
    leaves as it was; returns ``order``."""
    _check(keys)
    n, dev = keys.shape[0], keys.device
    keys = keys.contiguous()
    counts = it = None
    it_value = sort_every = 0
    if cadence is not None and cadence[2] > 1:
        counts, it, sort_every = cadence
        if counts.device != dev or counts.dtype != torch.int64 or \
                counts.dim() != 1 or not counts.is_contiguous():
            raise ValueError("cadence counts must be a contiguous [C] int64 "
                             "tensor on the keys' device")
        if torch.is_tensor(it):
            if it.device != dev or it.dtype != torch.int64 or it.dim() != 0:
                raise ValueError("cadence it must be an int or a 0-d int64 "
                                 "tensor on the keys' device")
        else:
            it, it_value = None, int(it)
    if order.shape != (n,) or order.dtype != torch.int64 or \
            order.device != dev or not order.is_contiguous():
        raise ValueError("order must be a contiguous [N] int64 tensor on the "
                         "keys' device")
    scratch = torch.empty(scratch_bytes(n), dtype=torch.uint8, device=dev)
    rc = _kernels().rtjax_key_sort(
        keys.data_ptr(), order.data_ptr(), scratch.data_ptr(), n,
        None if counts is None else counts.data_ptr(),
        None if it is None else it.data_ptr(), it_value, sort_every,
        tally(dev).data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"key sort launch failed: CUDA error {rc}")
    LAUNCHES["key_sort"] += 1
    return order
