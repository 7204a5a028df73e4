"""Builds of the port's native code, at first use, into ``build/rtjax_torch/``
under the repository root (a directory that .gitignore lists).

- the sweep-SAH BVH builder: rtjax's C++ source
  (``rtjax/accel/cpp/bvh_builder.cpp``, a plain C ABI), compiled by g++ with
  rtjax's own flags;
- the traversal kernels, one shared library with a plain C interface per
  ``rtjax_torch/csrc/*.cu`` source (the persistent walkers, the two-level
  kernels, the packet and lane group walks, which include ``wide_walk.cuh``,
  the first two also ``fetch_walk.cuh``, the packet and lane kernels
  ``group_walk.cuh``, ``packet_walk.cuh``, ``lane_walk.cuh`` and, through
  it, ``fetch_walk.cuh``; the binary-BVH walk, ``binary_traverse.cu``,
  includes ``fetch_walk.cuh`` for its resident grid, and the tiny-scene
  direct path, ``direct_traverse.cu``, includes ``direct_math.cuh``), the
  device loop of a captured step (``graph_loop.cu``: a CUDA-graph while
  node and its condition kernel, render/device_loop.py), and the fused
  wavefront step (``step_kernels.cu``: route, shade and resolve, which
  include ``step_math.cuh``; kernels/step.py) and the step's stable key
  sort (``key_sort.cu``, which includes ``key_sort.cuh``;
  kernels/sort.py), and the TPU probes' counterparts (``probes.cu``, which
  includes ``probes.cuh`` and ``mxu_probes.cuh``; kernels/probes.py), compiled by nvcc for
  ``sm_90a`` and bound with ctypes.

Each library is rebuilt when a source or a header it includes is newer
than it.  nvcc runs with ``-Xptxas -v``: each kernel's registers, stack
frame, spills and shared memory go to ``<library>.log`` beside it
(:func:`ptxas_report`).  A build writes a private temporary file and renames it into
place, so concurrent processes never load a half-written library; builds
of different libraries may run at once (one lock per library).  A failed
build raises; there is no fallback.  Delete ``build/rtjax_torch/`` to force
a rebuild.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "rtjax_torch"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BVH_SOURCE = REPO_ROOT / "rtjax" / "accel" / "cpp" / "bvh_builder.cpp"
PERSIST_SOURCE = CSRC_DIR / "persist_traverse.cu"
WIDE_INST_SOURCE = CSRC_DIR / "wide_inst_traverse.cu"
PACKET_SOURCE = CSRC_DIR / "packet_traverse.cu"
BINARY_SOURCE = CSRC_DIR / "binary_traverse.cu"
DIRECT_SOURCE = CSRC_DIR / "direct_traverse.cu"
DIRECT_HEADER = CSRC_DIR / "direct_math.cuh"
LOOP_SOURCE = CSRC_DIR / "graph_loop.cu"
STEP_SOURCE = CSRC_DIR / "step_kernels.cu"
STEP_HEADER = CSRC_DIR / "step_math.cuh"
SORT_SOURCE = CSRC_DIR / "key_sort.cu"
SORT_HEADER = CSRC_DIR / "key_sort.cuh"
PROBES_SOURCE = CSRC_DIR / "probes.cu"
PROBES_HEADER = CSRC_DIR / "probes.cuh"
MXU_HEADER = CSRC_DIR / "mxu_probes.cuh"
WALK_HEADER = CSRC_DIR / "wide_walk.cuh"
FETCH_HEADER = CSRC_DIR / "fetch_walk.cuh"
GROUP_HEADER = CSRC_DIR / "group_walk.cuh"
PACKET_HEADER = CSRC_DIR / "packet_walk.cuh"
LANE_HEADER = CSRC_DIR / "lane_walk.cuh"

# the BVH builder keeps rtjax's flags: -ffp-contract=off keeps SAH costs
# free of FMA contraction, so both packages build bit-identical trees
GXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC"]
# --fmad=false: no multiply-add contraction, so the kernels round every
# product and sum like the separate torch ops of their plain versions
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _build(out: Path, sources: list[Path], cmd_prefix: list[str],
           headers: tuple[Path, ...] = ()) -> Path:
    with _locks_lock:
        lock = _locks.setdefault(out.name, threading.Lock())
    with lock:
        if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime
                                for s in (*sources, *headers)):
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = cmd_prefix + ["-o", str(tmp)] + [str(s) for s in sources]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"build of {out.name} failed:\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
        return out


def ptxas_report(lib: Path) -> list[tuple[str, str]]:
    """``(kernel, resources)`` per kernel from a library's build log:
    ptxas's register, stack-frame, spill and shared-memory lines joined,
    the kernel named by its mangled name."""
    log = lib.with_suffix(".log")
    if not log.exists():
        return []
    report, name, parts = [], None, []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            if name:
                report.append((name, "; ".join(parts)))
            name, parts = line.split("'")[1], []
        elif name and ("stack frame" in line or "Used" in line):
            parts.append(line.split(":", 1)[-1].strip())
    if name:
        report.append((name, "; ".join(parts)))
    return report


def bvh_library() -> Path:
    """Path of the compiled BVH builder (built if missing or stale)."""
    return _build(BUILD_DIR / "libbvh.so", [BVH_SOURCE], ["g++"] + GXX_FLAGS)


def persist_library() -> Path:
    """Path of the compiled persistent-walker kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libpersist_traverse.so", [PERSIST_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (WALK_HEADER, FETCH_HEADER))


def wide_inst_library() -> Path:
    """Path of the compiled two-level kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libwide_inst_traverse.so", [WIDE_INST_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (WALK_HEADER, FETCH_HEADER))


def packet_library() -> Path:
    """Path of the compiled packet and lane kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libpacket_traverse.so", [PACKET_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS,
                  (WALK_HEADER, FETCH_HEADER, GROUP_HEADER, PACKET_HEADER,
                   LANE_HEADER))


def binary_library() -> Path:
    """Path of the compiled binary-BVH walk kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libbinary_traverse.so", [BINARY_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (WALK_HEADER, FETCH_HEADER))


def direct_library() -> Path:
    """Path of the compiled direct-path kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libdirect_traverse.so", [DIRECT_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (DIRECT_HEADER,))


def loop_library() -> Path:
    """Path of the compiled device-loop helpers of captured graphs (built
    if missing or stale)."""
    return _build(BUILD_DIR / "libgraph_loop.so", [LOOP_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS)


def step_library() -> Path:
    """Path of the compiled step kernels (built if missing or stale)."""
    return _build(BUILD_DIR / "libstep_kernels.so", [STEP_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (STEP_HEADER,))


def key_sort_library() -> Path:
    """Path of the compiled key sort (built if missing or stale)."""
    return _build(BUILD_DIR / "libkey_sort.so", [SORT_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (SORT_HEADER,))


def probes_library() -> Path:
    """Path of the compiled probe kernels (built if missing or stale)."""
    return _build(BUILD_DIR / "libprobes.so", [PROBES_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (PROBES_HEADER, MXU_HEADER))
