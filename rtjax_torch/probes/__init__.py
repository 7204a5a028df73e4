"""The port's probe scripts: the Hopper counterparts of rtjax's TPU probe
scripts, each named as the script it stands for.

- :mod:`rtjax_torch.probes.micro_kernel` (benchmarks/micro_kernel.py):
  the walk primitives, ``python -m rtjax_torch.probes.micro_kernel
  [names]``;
- :mod:`rtjax_torch.probes.stage_bench` (benchmarks/stage_bench.py's
  no-op launch): a launch's and a graph node's fixed cost, ``python -m
  rtjax_torch.probes.stage_bench``.

The kernels and their plain versions are kernels/probes.py's.  This
module holds what both scripts share: the card's name, power limit and
SM clock (:func:`card`), the device time of a launch (:func:`launch_ms`,
CUDA events between launches queued behind a spin kernel), and the
instructions of a probe kernel's iteration read from the library's SASS
(:func:`loop_instructions`), which set a probe's issue bound.  Every
number comes from the card: with no CUDA device the scripts exit.
"""

from __future__ import annotations

import re
import statistics
import subprocess
from pathlib import Path

# the spin that holds the stream while the host queues the timed launches
# (torch.cuda._sleep cycles: ~34 ms at the H100's 1.98 GHz)
SPIN_CYCLES = 1 << 26
ISSUE_PER_CLOCK = 4   # warp-instructions an SM issues a clock (4 schedulers)


def need_card():
    """Exit unless there is a CUDA device: a probe's numbers are the
    card's."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("the probes time the card: torch.cuda.is_available()"
                         " is False")


def card() -> dict:
    """The card's name, power limit and maximum SM clock as nvidia-smi
    reads them, its SM count and the line nvidia-smi prints."""
    import torch
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    name, power, clock = (s.strip() for s in line.split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(name=name, power_limit=power,
                clock_mhz=float(clock.split()[0]), sms=sms,
                line=f"{name}, {power}", clock=clock)


def launch_ms(fn, reps: int = 3) -> tuple[float, float, float]:
    """``(mean, least, most)`` device time (ms) of one call of ``fn`` over
    ``reps`` calls after one warm-up: the calls are queued behind a spin
    kernel (``torch.cuda._sleep``) with a CUDA event before and after each,
    so the events time the card's work back to back and not the host's
    launch.  The stream must still be busy with the spin when the last
    event is queued; if it is not, the spin is lengthened and the timing
    made again, three times at most.  Events between calls cost ~5 us a
    call of their own (PERF.md row 11a): time a short kernel in a chain
    of calls between two events (:func:`chain_ms`)."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(cycles)
        ev[0].record()
        for e in ev[1:]:
            fn()
            e.record()
        held = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        if held:
            ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            return statistics.mean(ms), min(ms), max(ms)
        cycles *= 4
    raise RuntimeError("the host queued the timed calls for longer than "
                       "the spin held the stream, three times")


def chain_ms(make_calls, reps: int = 3) -> tuple[float, float, float]:
    """``(mean, least, most)`` device time (ms) of one call in a chain:
    ``make_calls()`` returns k prepared calls (each launching one kernel);
    each of ``reps`` chains (after one warm-up chain) is queued behind a
    spin kernel with one CUDA event before its first call and one after
    its last, and timed per call.  ``make_calls`` runs before the chain's
    first event, so a kernel that writes its own inputs gets a state copy
    a call made there, outside the timed span.  As :func:`launch_ms`, the
    spin is lengthened and the chains timed again if the host queued them
    for longer than it held the stream."""
    import torch
    for call in make_calls():
        call()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(3):
        chains = [make_calls() for _ in range(reps)]
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in chains]
        torch.cuda._sleep(cycles)
        for (start, end), calls in zip(ev, chains):
            start.record()
            for call in calls:
                call()
            end.record()
        held = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        if held:
            ms = [a.elapsed_time(b) / len(c) for (a, b), c in zip(ev, chains)]
            return statistics.mean(ms), min(ms), max(ms)
        cycles *= 4
    raise RuntimeError("the host queued the timed chains for longer than "
                       "the spin held the stream, three times")


def call_ms(fn, reps: int = 3) -> float:
    """Median device time (ms) of one call of ``fn`` with its host launch
    (CUDA events around each call, synchronised), after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slope_ns(t_n: float, t_4n: float, n: int, factor: int = 4) -> float:
    """ns an iteration from the ms of n and ``factor`` x n iterations (the
    two-point slope: a launch's fixed cost cancels)."""
    return (t_4n - t_n) / (n * (factor - 1)) * 1e6


# --------------------------------------------------------------- the SASS
_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_HMMA = re.compile(r"\bHMMA\.")
_TARGET = re.compile(
    r"\b(?:BRA|JMP)\b[^;]*?(?:0x([0-9a-f]+)|`\((\.L_x_\d+)\))")


def _functions(sass: str) -> dict:
    """``{function: [(address, text), ...], labels}`` of cuobjdump's SASS:
    each function's instructions and its labels' addresses."""
    out, cur = {}, None
    pending = []
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = out.setdefault(m[1], ([], {}))
            pending = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m[1])
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m[1], 16)
            for label in pending:
                cur[1][label] = addr
            pending = []
            cur[0].append((addr, m[2].strip()))
    return out


def _target(text: str, labels: dict):
    m = _TARGET.search(text)
    if m is None:
        return None
    return int(m[1], 16) if m[1] else labels.get(m[2])


def loop_body(instrs: list, labels: dict) -> list:
    """The instructions of a kernel's main loop: from the target of its
    widest backward branch to that branch, without the blocks that call
    out of line (an IEEE division's slow path), which an iteration runs
    only for operands the fast path does not take."""
    back = [(addr, t) for addr, text in instrs
            if (t := _target(text, labels)) is not None and t <= addr]
    if not back:
        return []
    end, start = max(back, key=lambda b: b[0] - b[1])
    body = [(a, s) for a, s in instrs if start <= a <= end]
    targets = {t for _, s in body if (t := _target(s, labels)) is not None}
    blocks, block = [], []
    for a, s in body:
        if block and a in targets:
            blocks.append(block)
            block = []
        block.append(s)
        if _target(s, labels) is not None or s.split()[-1:] == ["EXIT"]:
            blocks.append(block)
            block = []
    if block:
        blocks.append(block)
    return [s for b in blocks if not any("CALL" in s for s in b) for s in b]


def mma_loop(instrs: list, labels: dict) -> list:
    """The instructions of the innermost loop that issues an HMMA: the
    narrowest backward branch whose span holds one (a tensor-core probe's
    iteration loop; its chunk loop around it is wider), without the
    out-of-line blocks, as :func:`loop_body`."""
    spans = sorted((addr - t, t, addr) for addr, text in instrs
                   if (t := _target(text, labels)) is not None and t <= addr)
    for _, start, end in spans:
        if any(start <= a <= end and _HMMA.search(s) for a, s in instrs):
            inner = [(a, s) for a, s in instrs if start <= a <= end]
            return loop_body(inner, labels)
    return []


def loop_instructions(sass: str) -> dict:
    """``{function: instructions}``: a warp's instructions in one
    iteration of each function's main loop (:func:`loop_body`), from
    cuobjdump's SASS of a library."""
    return {name: len(loop_body(*f)) for name, f in _functions(sass).items()}


def mma_loop_instructions(sass: str) -> dict:
    """``{function: (instructions, hmma)}``: a warp's instructions, and its
    HMMA instructions, in one iteration of each function's innermost loop
    that issues one (:func:`mma_loop`); (0, 0) for a function with
    none."""
    out = {}
    for name, f in _functions(sass).items():
        body = mma_loop(*f)
        out[name] = (len(body), sum(bool(_HMMA.search(s)) for s in body))
    return out


def library_sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a library (the CUDA toolkit's, beside
    nvcc)."""
    from ..kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def issue_bound_cycles(instructions: int, warps: int) -> float:
    """Least cycles of an iteration of ``warps`` warps on one SM that each
    issue ``instructions``: 4 warp-instructions a clock, and one a clock
    for a warp."""
    return max(instructions * warps / ISSUE_PER_CLOCK, float(instructions))
