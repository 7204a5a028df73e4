"""The kernel modules' launch and plain-call counters, taken together.

Every kernel module counts its wrappers' kernel launches (``LAUNCHES``,
``STATS_LAUNCHES`` and the first designs' ``*_LAUNCHES``) and its plain
versions' calls (``REF_CALLS``) in module-level dicts of Python ints,
added to where a wrapper launches or a plain version runs.  The frame loop
(render/wavefront.py) keeps them true where no wrapper runs: a replayed
CUDA graph adds the captured step's launches (render/graph.py), and the
steps that run past the end of a frame's last chunk are taken back out.
"""

from __future__ import annotations

from . import (direct, lane, persist, sort, step, traversal, wide,
               wide_inst)

_MODULES = (persist, wide, lane, wide_inst, traversal, direct, step, sort)


def counters() -> dict:
    """``{(module name, counter name): dict}`` of every counter."""
    return {(m.__name__.rsplit(".", 1)[1], name): v
            for m in _MODULES for name, v in vars(m).items()
            if name.endswith(("LAUNCHES", "REF_CALLS"))
            and isinstance(v, dict)}


def snapshot() -> dict:
    """A copy of every counter."""
    return {k: dict(v) for k, v in counters().items()}


def restore(snap: dict) -> None:
    """Set every counter back to ``snap`` (in place)."""
    for k, v in counters().items():
        v.update(snap[k])


def delta(before: dict, after: dict) -> dict:
    """The counts added between two snapshots (non-zero entries only)."""
    return {(k, kind): after[k][kind] - n for k, c in before.items()
            for kind, n in c.items() if after[k][kind] != n}


def add(diff: dict, times: int = 1) -> None:
    """Add ``times`` x a :func:`delta` to the counters."""
    cs = counters()
    for (k, kind), n in diff.items():
        cs[k][kind] += n * times
