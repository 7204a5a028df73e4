"""A launch's and a graph node's fixed cost on the card: the Hopper
counterpart of the no-op launch of rtjax's benchmarks/stage_bench.py
(:112-130, ``nop_launch``: one Pallas launch copying a [16, 128] f32 tile,
then its sum).

The copy kernel (kernels/probes.py :func:`nop_copy`, csrc/probes.cu)
moves 8 KB in and 8 KB out, 4.9 ns at 3.35 TB/s, so its time is what a
launch costs on the card, in device time between CUDA events (launches
queued behind a spin kernel, :func:`rtjax_torch.probes.launch_ms`).  Two
events around one launch cost ~5 us of their own, so a launch's time is
read from a chain of CHAIN launches between two events, per launch:

- eager: the copies chained (each reading what the one before wrote);
- programmatic: the chain, each copy a programmatic dependent of the one
  before (``cudaLaunchAttributeProgrammaticStreamSerialization``, as
  csrc/key_sort.cu's passes launch);
- graph: the chain captured as a CUDA graph, one replay, per node;
- the sum kernel in a chain of sums; one host-visible call of
  ``nop_launch`` (copy and sum, host launch included) in CUDA events
  around it; one copy between two events (the events' floor);
- ``torch.Tensor.copy_`` of the same tile (a library call) chained and
  alone, and the plain versions (``clone``, ``sum``) chained;
- at one tile and at the full card (every SM times the copy's resident
  blocks, each copying its own tile).

rtjax's own script times its XLA stages too (sort, RNG, scatter, cumsum,
a shading stand-in); none of them is a Pallas kernel, and they stay with
the port of benchmarks/step_anatomy.py (ROADMAP Queue A 6).

Usage: python -m rtjax_torch.probes.stage_bench
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import call_ms, card, launch_ms, need_card
from ..kernels import probes as PK

CHAIN = 64   # launches a chain, a captured graph's nodes
REPS = 3     # timed calls of each


def _chain(op, x, y):
    """CHAIN calls of ``op(a, b)``, a and b swapping after each (x -> y
    -> x ...: a copy reads what the one before wrote)."""
    def run():
        a, b = x, y
        for _ in range(CHAIN):
            op(a, b)
            a, b = b, a
    return run


def _graph(fn):
    """``fn`` captured as a CUDA graph (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    torch.cuda.synchronize()
    return g


def run() -> dict:
    """The no-op launch's timings (ms) at one tile and at the full card;
    a ``*chain*`` or graph time is per call."""
    info = card()
    out = {}
    for grid in ("one_tile", "full_card"):
        tiles = 1 if grid == "one_tile" else PK.full_card("nop_copy")
        shape = (16, 128) if tiles == 1 else (tiles, 16, 128)
        x = torch.zeros(shape, dtype=torch.float32, device="cuda")
        y = torch.empty_like(x)
        per = lambda fn: launch_ms(fn, REPS)[0] / CHAIN  # noqa: E731
        rec = dict(tiles=tiles)
        rec["chain_ms"] = per(_chain(PK.nop_copy, x, y))
        rec["chain_pdl_ms"] = per(_chain(
            lambda a, b: PK.nop_copy(a, b, pdl=True), x, y))
        rec["graph_node_ms"] = per(_graph(_chain(PK.nop_copy, x, y)).replay)
        rec["sum_chain_ms"] = per(_chain(lambda a, b: PK.tile_sum(a), x, y))
        rec["host_call_ms"] = call_ms(lambda: PK.nop_launch(x), REPS)
        rec["eager_ms"] = launch_ms(lambda: PK.nop_copy(x, y), REPS)[0]
        rec["copy__chain_ms"] = per(_chain(lambda a, b: b.copy_(a), x, y))
        rec["copy__ms"] = launch_ms(lambda: y.copy_(x), REPS)[0]
        rec["plain_copy_chain_ms"] = per(_chain(
            lambda a, b: PK.nop_copy_ref(a), x, y))
        rec["plain_sum_chain_ms"] = per(_chain(
            lambda a, b: PK.tile_sum_ref(a), x, y))
        out[grid] = rec
    out["card"] = info
    return out


def main(argv=None) -> dict:
    """Print one line a timing, as rtjax's ``timeit`` does, and return
    :func:`run`'s records."""
    argparse.ArgumentParser(prog="python -m rtjax_torch.probes.stage_bench",
                            description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    need_card()
    out = run()
    print(f"{out['card']['line']}")
    labels = {"chain_ms": f"copy kernel in a chain of {CHAIN}",
              "chain_pdl_ms": f"programmatic copy in a chain of {CHAIN}",
              "graph_node_ms": f"graph node ({CHAIN} copies)",
              "sum_chain_ms": f"tile sum kernel in a chain of {CHAIN}",
              "host_call_ms": "one host-visible nop_launch call",
              "eager_ms": "one copy kernel between events",
              "copy__chain_ms": f"torch.Tensor.copy_ in a chain of {CHAIN}",
              "copy__ms": "one torch.Tensor.copy_ between events",
              "plain_copy_chain_ms": f"plain copy (clone) in a chain of "
                                     f"{CHAIN}",
              "plain_sum_chain_ms": f"plain sum in a chain of {CHAIN}"}
    for grid in ("one_tile", "full_card"):
        rec = out[grid]
        for key, label in labels.items():
            print(f"{label + ', ' + grid.replace('_', ' '):52s} "
                  f"{rec[key]:9.5f} ms  [{rec['tiles']} tiles]", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
