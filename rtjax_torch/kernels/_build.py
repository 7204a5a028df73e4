"""Builds of the port's native code, at first use, into ``build/rtjax_torch/``
under the repository root (a directory that .gitignore lists).

- the sweep-SAH BVH builder: rtjax's C++ source
  (``rtjax/accel/cpp/bvh_builder.cpp``, a plain C ABI), compiled by g++ with
  rtjax's own flags;
- the traversal kernels, one shared library with a plain C interface per
  ``rtjax_torch/csrc/*.cu`` source (the persistent walkers, the two-level
  kernels, the packet and lane group walks; all include ``wide_walk.cuh``,
  the group walks also ``group_walk.cuh``), compiled by nvcc for
  ``sm_90a`` and bound with ctypes.

Each library is rebuilt when a source or a header it includes is newer
than it.  A build writes a private temporary file and renames it into
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
WALK_HEADER = CSRC_DIR / "wide_walk.cuh"
GROUP_HEADER = CSRC_DIR / "group_walk.cuh"

# the BVH builder keeps rtjax's flags: -ffp-contract=off keeps SAH costs
# free of FMA contraction, so both packages build bit-identical trees
GXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC"]
# --fmad=false: no multiply-add contraction, so the kernels round every
# product and sum like the separate torch ops of their plain versions
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

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
        os.replace(tmp, out)
        return out


def bvh_library() -> Path:
    """Path of the compiled BVH builder (built if missing or stale)."""
    return _build(BUILD_DIR / "libbvh.so", [BVH_SOURCE], ["g++"] + GXX_FLAGS)


def persist_library() -> Path:
    """Path of the compiled persistent-walker kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libpersist_traverse.so", [PERSIST_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (WALK_HEADER,))


def wide_inst_library() -> Path:
    """Path of the compiled two-level kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libwide_inst_traverse.so", [WIDE_INST_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (WALK_HEADER,))


def packet_library() -> Path:
    """Path of the compiled packet and lane kernels (built if missing or
    stale)."""
    return _build(BUILD_DIR / "libpacket_traverse.so", [PACKET_SOURCE],
                  [nvcc_path()] + NVCC_FLAGS, (WALK_HEADER, GROUP_HEADER))
