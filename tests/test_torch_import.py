"""rtjax_torch imports torch and never JAX, and its build module imports
(and fails cleanly at build time) where there is no CUDA toolkit."""

import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

MODULES = [
    "rtjax_torch", "rtjax_torch.constants", "rtjax_torch.config",
    "rtjax_torch.scenes", "rtjax_torch.core.vec", "rtjax_torch.core.rng",
    "rtjax_torch.core.sampling", "rtjax_torch.core.geometry",
    "rtjax_torch.scene.transform", "rtjax_torch.scene.mesh",
    "rtjax_torch.scene.camera", "rtjax_torch.scene.material",
    "rtjax_torch.scene.light", "rtjax_torch.scene.scene",
    "rtjax_torch.accel", "rtjax_torch.accel.bvh",
    "rtjax_torch.accel.builder_cpp", "rtjax_torch.accel.builder_np",
    "rtjax_torch.accel.wide", "rtjax_torch.accel.instancing",
    "rtjax_torch.kernels._build", "rtjax_torch.kernels.persist",
    "rtjax_torch.kernels.wide_inst", "rtjax_torch.kernels.wide",
    "rtjax_torch.kernels.lane", "rtjax_torch.kernels.brute",
    "rtjax_torch.kernels.traversal", "rtjax_torch.kernels.direct",
    "rtjax_torch.kernels.step", "rtjax_torch.kernels.counts",
    "rtjax_torch.render", "rtjax_torch.render.graph",
    "rtjax_torch.render.trace",
    "rtjax_torch.render.sorting", "rtjax_torch.render.wavefront",
    "rtjax_torch.render.film", "rtjax_torch.render.checkpoint",
    "rtjax_torch.utils", "rtjax_torch.utils.log",
    "rtjax_torch.utils.profiler", "rtjax_torch.utils.compare",
    "rtjax_torch.cli", "rtjax_torch.__main__", "rtjax_torch.parallel",
    "rtjax_torch.parallel.multihost", "rtjax_torch.parallel.sharding",
]


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules "
            "if k.startswith('jax'))\n"
            "assert not any(k == 'rtjax' or k.startswith('rtjax.') "
            "for k in sys.modules)\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("module", ["rtjax_torch.kernels.brute",
                                    "rtjax_torch.kernels.direct",
                                    "rtjax_torch.kernels.step",
                                    "rtjax_torch.accel",
                                    "rtjax_torch.render",
                                    "rtjax_torch.render.graph",
                                    "tools.step_designs"])
def test_host_surface_imports_no_jax(module):
    """Each module of rtjax's host and user surface, imported alone in a
    fresh interpreter, brings in neither JAX nor rtjax."""
    code = (f"import sys, {module}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'rtjax'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_kernel_build_without_nvcc_raises(tmp_path):
    """Without a CUDA toolkit the module imports; asking for the kernel
    library raises instead of falling back."""
    env = dict(os.environ, CUDA_HOME=str(tmp_path),
               PATH=os.pathsep.join(["/usr/bin", "/bin"]))
    code = ("from rtjax_torch.kernels import _build\n"
            "try:\n"
            "    _build.persist_library()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    res = _run(code, env)
    assert res.returncode == 0 and "raised: nvcc not found" in res.stdout, \
        res.stdout + res.stderr


@pytest.mark.parametrize("name", ["cuda_home", "path"])
def test_nvcc_lookup_prefers_cuda_home(tmp_path, monkeypatch, name):
    from rtjax_torch.kernels import _build
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    if name == "cuda_home":
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    else:
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "absent"))
        monkeypatch.setenv("PATH", str(fake.parent))
    assert _build.nvcc_path() == str(fake)


def test_two_level_build_without_nvcc_raises(tmp_path):
    env = dict(os.environ, CUDA_HOME=str(tmp_path),
               PATH=os.pathsep.join(["/usr/bin", "/bin"]))
    code = ("from rtjax_torch.kernels import _build\n"
            "try:\n"
            "    _build.wide_inst_library()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    res = _run(code, env)
    assert res.returncode == 0 and "raised: nvcc not found" in res.stdout, \
        res.stdout + res.stderr


def test_packet_build_without_nvcc_raises(tmp_path):
    env = dict(os.environ, CUDA_HOME=str(tmp_path),
               PATH=os.pathsep.join(["/usr/bin", "/bin"]))
    code = ("from rtjax_torch.kernels import _build\n"
            "try:\n"
            "    _build.packet_library()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    res = _run(code, env)
    assert res.returncode == 0 and "raised: nvcc not found" in res.stdout, \
        res.stdout + res.stderr


def test_kernel_libraries_rebuild_when_the_shared_header_changes(
        tmp_path, monkeypatch):
    """Every kernel library includes wide_walk.cuh, the persist and
    two-level libraries also fetch_walk.cuh, the packet library
    group_walk.cuh, packet_walk.cuh, lane_walk.cuh and (through the last)
    fetch_walk.cuh: a newer header makes them stale.  (A stand-in nvcc
    writes the -o file.)"""
    from rtjax_torch.kernels import _build
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(0o755)
    header = tmp_path / "wide_walk.cuh"
    header.write_text("// header\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    group = tmp_path / "group_walk.cuh"
    group.write_text("// header\n")
    fetch = tmp_path / "fetch_walk.cuh"
    fetch.write_text("// header\n")
    packet = tmp_path / "packet_walk.cuh"
    packet.write_text("// header\n")
    lane = tmp_path / "lane_walk.cuh"
    lane.write_text("// header\n")
    monkeypatch.setattr(_build, "WALK_HEADER", header)
    monkeypatch.setattr(_build, "GROUP_HEADER", group)
    monkeypatch.setattr(_build, "FETCH_HEADER", fetch)
    monkeypatch.setattr(_build, "PACKET_HEADER", packet)
    monkeypatch.setattr(_build, "LANE_HEADER", lane)
    for build, h in ((_build.persist_library, header),
                     (_build.persist_library, fetch),
                     (_build.wide_inst_library, header),
                     (_build.wide_inst_library, fetch),
                     (_build.packet_library, header),
                     (_build.packet_library, group),
                     (_build.packet_library, packet),
                     (_build.packet_library, lane),
                     (_build.packet_library, fetch)):
        for f in (header, group, fetch, packet, lane):
            os.utime(f, (0, 0))
        lib = build()
        assert lib.read_text() == "built\n"
        future = lib.stat().st_mtime + 100
        os.utime(lib, (future, future))
        assert build().stat().st_mtime == future   # fresh: not rebuilt
        os.utime(h, (future + 100, future + 100))
        assert build().stat().st_mtime != future   # header newer: rebuilt


def test_direct_build_without_nvcc_raises(tmp_path):
    env = dict(os.environ, CUDA_HOME=str(tmp_path),
               PATH=os.pathsep.join(["/usr/bin", "/bin"]))
    code = ("from rtjax_torch.kernels import _build\n"
            "try:\n"
            "    _build.direct_library()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    res = _run(code, env)
    assert res.returncode == 0 and "raised: nvcc not found" in res.stdout, \
        res.stdout + res.stderr


def test_loop_build_without_nvcc_raises(tmp_path):
    env = dict(os.environ, CUDA_HOME=str(tmp_path),
               PATH=os.pathsep.join(["/usr/bin", "/bin"]))
    code = ("from rtjax_torch.kernels import _build\n"
            "try:\n"
            "    _build.loop_library()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    res = _run(code, env)
    assert res.returncode == 0 and "raised: nvcc not found" in res.stdout, \
        res.stdout + res.stderr


@pytest.mark.parametrize("name", ["wide_walk.cuh", "fetch_walk.cuh"])
def test_binary_library_rebuilds_when_its_headers_change(tmp_path,
                                                         monkeypatch, name):
    """The binary walk's fetch design includes fetch_walk.cuh (and through
    it wide_walk.cuh): a newer one makes its library stale."""
    from rtjax_torch.kernels import _build
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(0o755)
    headers = {}
    for h, attr in (("wide_walk.cuh", "WALK_HEADER"),
                    ("fetch_walk.cuh", "FETCH_HEADER")):
        headers[h] = tmp_path / h
        headers[h].write_text("// header\n")
        os.utime(headers[h], (0, 0))
        monkeypatch.setattr(_build, attr, headers[h])
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    lib = _build.binary_library()
    future = lib.stat().st_mtime + 100
    os.utime(lib, (future, future))
    assert _build.binary_library().stat().st_mtime == future
    os.utime(headers[name], (future + 100, future + 100))
    assert _build.binary_library().stat().st_mtime != future
