"""rtjax_torch.parallel: sample-space sharding over torch.distributed, on the
CPU with gloo, after rtjax's tests/test_parallel.py and test_multihost.py.

(a) A world of one (no process group) renders bit for bit what
    ``render_frame_linear`` renders from ``rank_generator(seed, 0)``.
(b) Two gloo ranks (subprocesses joined through a file in ``tmp_path``)
    hold the same reduced framebuffer, bit for bit the in-process sum of
    the two ranks' frames (one float add); ``rays_traced`` is the sum and
    ``iterations`` the maximum of theirs, exactly.
(c) The two-rank frame agrees with rtjax's ``render_frame_sharded`` on the
    8-device CPU mesh within rtjax's own tolerance (test_parallel.py's
    configuration): |mean difference| < 0.01, MSE < 0.004.
(d) ``render_checkpointed(mesh=)`` over the two ranks: rank 0 alone saves;
    a resume from a file one batch short is bitwise the uninterrupted run;
    a world of one is bitwise the unsharded checkpoint; the two ranks' file
    resumes in a world of one.
(e) ``init_multihost`` / ``process_info`` in two processes, the backend
    choice, and the CLI's ``--sharded``: in process as a world of one, and
    under ``torchrun`` with two CPU ranks.
"""

import dataclasses
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax.parallel import render_frame_sharded as jax_sharded

from rtjax_torch import RenderConfig, cli
from rtjax_torch.parallel import (Mesh, default_backend, make_mesh,
                                  rank_generator, render_frame_linear_sharded,
                                  render_frame_sharded)
from rtjax_torch.render.checkpoint import (batch_generator,
                                           render_checkpointed)
from rtjax_torch.render.film import read_ppm
from rtjax_torch.render.wavefront import render_frame_linear
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays
from rtjax_torch.utils.compare import mse

from scenes import cornell, default_camera
from test_torch_scene import camera_arrays, scene_arrays

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TIMEOUT = 300

# (b): a small frame; (c): rtjax's test_sharded_matches_single_device
SMALL = dict(width=16, height=16, num_samples=4, max_bounces=2,
             num_working_paths=512)
PARITY = dict(width=32, height=32, num_samples=64, max_bounces=4,
              num_working_paths=2048)
# (d): four batches of two spp, saved after every batch
CKPT = dict(width=8, height=8, num_samples=8, max_bounces=2,
            num_working_paths=256)
BATCH = 2
SEED = 7

# One rank of the two-rank run: joins the gloo group through the file
# ``spec["init"]``, renders (b), (c) and (d), and saves what it holds.
_WORKER = r"""
import dataclasses, json, shutil, sys
import torch
import torch.distributed as dist
spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method=spec["init"], world_size=2,
                        rank=rank)
import pickle
from rtjax_torch import RenderConfig
from rtjax_torch.parallel import (make_mesh, render_frame_linear_sharded,
                                  render_frame_sharded)
from rtjax_torch.render import checkpoint as C
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays
with open(spec["scene"], "rb") as f:
    arrays = pickle.load(f)
scene = scene_from_arrays(arrays["scene"], "cpu")
cam = Camera.from_arrays(arrays["camera"], "cpu")
mesh = make_mesh("cpu")
assert (mesh.size, mesh.rank) == (2, rank)
out = {}
gen = torch.Generator().manual_seed(spec["seed"])
out["small"] = render_frame_linear_sharded(
    scene, cam, RenderConfig(**spec["small"]), gen, mesh)
out["parity"] = render_frame_sharded(
    scene, cam, RenderConfig(**spec["parity"]),
    torch.Generator().manual_seed(1), mesh)
saves = []
savez = C.np.savez
C.np.savez = lambda *a, **k: (saves.append(1), savez(*a, **k))[1]
ck = RenderConfig(**spec["ckpt"])
kw = dict(batch_spp=spec["batch"], verbose=False, save_every=1, mesh=mesh)
full = C.render_checkpointed(scene, cam, ck, spec["full"], **kw)
C.render_checkpointed(
    scene, cam, dataclasses.replace(ck, num_samples=ck.num_samples
                                    - spec["batch"]), spec["resume"], **kw)
if rank == 0:
    shutil.copy(spec["resume"], spec["short"])
dist.barrier()
resumed = C.render_checkpointed(scene, cam, ck, spec["resume"], **kw)
out["ckpt"] = (full, resumed, len(saves))
torch.save(out, f"{spec['out']}/rank{rank}.pt")
dist.destroy_process_group()
"""


def _env():
    """The ranks' environment: the repository importable, and one thread a
    rank (the frames are small; the test workers share the cores)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_ranks(code, argv_of_rank, n=2):
    """Run ``code`` in ``n`` processes (rank r gets ``argv_of_rank(r)``),
    all started together; their stdouts, after each exits with 0."""
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               *argv_of_rank(r)], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def carried():
    """rtjax's scene and camera of test_parallel.py, and the port's copies
    carried across with ``scene_from_arrays``."""
    jscene, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    arrays = {"scene": scene_arrays(jscene), "camera": camera_arrays(jcam)}
    return (jscene, jcam, arrays, scene_from_arrays(arrays["scene"], "cpu"),
            Camera.from_arrays(arrays["camera"], "cpu"))


@pytest.fixture(scope="module")
def two_ranks(carried, tmp_path_factory):
    """The two-rank run's outputs: ``([rank 0's, rank 1's], spec)``."""
    *_, arrays, _, _ = carried
    d = tmp_path_factory.mktemp("two_ranks")
    with open(d / "scene.pkl", "wb") as f:
        pickle.dump(arrays, f)
    spec = dict(init=f"file://{d}/pg", scene=str(d / "scene.pkl"),
                seed=SEED, small=SMALL, parity=PARITY, ckpt=CKPT,
                batch=BATCH, full=str(d / "full.npz"),
                resume=str(d / "resume.npz"), short=str(d / "short.npz"),
                out=str(d))
    (d / "spec.json").write_text(json.dumps(spec))
    _run_ranks(_WORKER, lambda r: [str(d / "spec.json"), str(r)])
    return [torch.load(d / f"rank{r}.pt") for r in range(2)], spec


# ------------------------------------------------------- (a) world of one

def test_world_of_one_is_the_unsharded_frame(carried):
    *_, scene, cam = carried
    cfg = RenderConfig(**SMALL)
    mesh = make_mesh("cpu")
    assert mesh == Mesh(None, 1, 0, torch.device("cpu"))
    fb, stats = render_frame_linear_sharded(
        scene, cam, cfg, torch.Generator().manual_seed(SEED), mesh)
    want, wstats = render_frame_linear(scene, cam, cfg,
                                       rank_generator(SEED, 0, "cpu"))
    assert torch.equal(fb, want)
    assert stats == {"iterations": wstats["iterations"],
                     "rays_traced": wstats["rays_traced"]}
    img, _ = render_frame_sharded(scene, cam, cfg,
                                  torch.Generator().manual_seed(SEED))
    assert torch.equal(img, torch.sqrt(want / cfg.num_samples))


def test_sharded_checks_its_inputs(carried):
    *_, scene, cam = carried
    gen = torch.Generator().manual_seed(SEED)
    with pytest.raises(ValueError, match="divide by the mesh size 3"):
        render_frame_linear_sharded(scene, cam, RenderConfig(**SMALL), gen,
                                    Mesh(None, 3, 0, torch.device("cpu")))
    with pytest.raises(TypeError, match="Mesh"):
        render_frame_linear_sharded(scene, cam, RenderConfig(**SMALL), gen,
                                    object())
    with pytest.raises(ValueError, match="renders on"):
        render_frame_linear_sharded(scene, cam, RenderConfig(**SMALL), gen,
                                    Mesh(None, 1, 0, torch.device("meta")))


def test_rank_generators_are_seeded_apart():
    assert rank_generator(SEED, 0, "cpu").initial_seed() == SEED
    seeds = {rank_generator(SEED, r, "cpu").initial_seed() for r in range(4)}
    assert len(seeds) == 4
    assert rank_generator(SEED, 3, "cpu").initial_seed() == \
        batch_generator(SEED, 3, "cpu").initial_seed()


# ------------------------------------------------------ (b) two gloo ranks

def test_two_ranks_hold_the_summed_frame(carried, two_ranks):
    *_, scene, cam = carried
    outs, _ = two_ranks
    (fb0, st0), (fb1, st1) = outs[0]["small"], outs[1]["small"]
    assert torch.equal(fb0, fb1)
    assert st0 == st1
    local = RenderConfig(**dict(SMALL, num_samples=SMALL["num_samples"] // 2))
    frames = [render_frame_linear(scene, cam, local,
                                  rank_generator(SEED, r, "cpu"))
              for r in range(2)]
    assert torch.equal(fb0, frames[0][0] + frames[1][0])
    assert st0["rays_traced"] == sum(f[1]["rays_traced"] for f in frames)
    assert st0["iterations"] == max(f[1]["iterations"] for f in frames)
    assert not torch.equal(frames[0][0], frames[1][0])


def test_two_rank_frame_matches_rtjax_sharded(carried, two_ranks):
    """rtjax's test_sharded_matches_single_device, its sharded frame over
    the conftest's 8 CPU devices against the port's over two ranks."""
    jscene, jcam, *_ = carried
    outs, _ = two_ranks
    (img0, stats), (img1, _) = outs[0]["parity"], outs[1]["parity"]
    assert torch.equal(img0, img1)
    assert jax.device_count() == 8
    fb_j, _ = jax_sharded(jscene, jcam, JaxConfig(**PARITY),
                          jax.random.key(1))
    img_j = np.asarray(fb_j).reshape(32, 32, 3)
    img = img0.numpy().reshape(32, 32, 3)
    assert abs(img.mean() - img_j.mean()) < 0.01
    assert mse(img, img_j) < 0.004
    assert stats["rays_traced"] > 0


# ------------------------------------------------------- (d) checkpoints

def test_sharded_checkpoint_over_two_ranks(two_ranks):
    outs, spec = two_ranks
    (full0, res0, saves0), (full1, res1, saves1) = (o["ckpt"] for o in outs)
    n_batches = CKPT["num_samples"] // BATCH
    # rank 0 alone saved: every batch of three runs (4 + 3 + 1 batches)
    assert (saves0, saves1) == (2 * n_batches, 0)
    assert torch.equal(full0, full1) and torch.equal(res0, res1)
    assert torch.equal(res0, full0)
    with np.load(spec["full"]) as ck:
        assert int(ck["batches_done"]) == n_batches
        assert torch.equal(
            torch.sqrt(torch.tensor(ck["fb"]) / CKPT["num_samples"]), full0)


def test_two_rank_file_resumes_in_a_world_of_one(carried, two_ranks,
                                                 tmp_path):
    *_, scene, cam = carried
    _, spec = two_ranks
    path = str(tmp_path / "ck.npz")
    shutil.copy(spec["short"], path)
    with np.load(path) as ck:
        prev = ck["fb"]
        assert int(ck["batches_done"]) == CKPT["num_samples"] // BATCH - 1
    cfg = RenderConfig(**CKPT)
    got = render_checkpointed(scene, cam, cfg, path, batch_spp=BATCH,
                              verbose=False, mesh=make_mesh("cpu"))
    last, _ = render_frame_linear(
        scene, cam, dataclasses.replace(cfg, num_samples=BATCH),
        batch_generator(cfg.seed, CKPT["num_samples"] // BATCH - 1, "cpu"))
    assert torch.equal(got, torch.sqrt((torch.tensor(prev) + last)
                                       / cfg.num_samples))


def test_world_of_one_checkpoint_is_the_unsharded_one(carried, tmp_path):
    *_, scene, cam = carried
    cfg = RenderConfig(**CKPT)
    kw = dict(batch_spp=BATCH, verbose=False)
    plain = render_checkpointed(scene, cam, cfg, str(tmp_path / "a.npz"),
                                **kw)
    one = render_checkpointed(scene, cam, cfg, str(tmp_path / "b.npz"),
                              mesh=make_mesh("cpu"), **kw)
    assert torch.equal(plain, one)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        for k in ("fb", "batches_done", "seed", "batch_spp", "fingerprint"):
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------- (e) start-up and the CLI

_JOIN = r"""
import sys
import torch
import torch.distributed as dist
from rtjax_torch.parallel import init_multihost, make_mesh, process_info
dev = init_multihost(sys.argv[1], 2, int(sys.argv[2]), device="cpu")
assert dist.get_backend() == "gloo" and dev == torch.device("cpu")
x = torch.tensor([1.0 + dist.get_rank()])
dist.all_reduce(x)
print("INFO", *process_info(), make_mesh("cpu").size, float(x))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_multihost_joins_two_processes():
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_ranks(_JOIN, lambda r: [coord, str(r)])
    infos = sorted(next(line for line in o.splitlines()
                        if line.startswith("INFO")).split()[1:]
                   for o in outs)
    assert infos == [["0", "2", "1", "2", "3.0"], ["1", "2", "1", "2", "3.0"]]


def test_default_backend_is_chosen_by_device():
    assert default_backend("cuda") == "nccl"
    assert default_backend(torch.device("cuda", 3)) == "nccl"
    assert default_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="meta"):
        default_backend("meta")


ARGS = ["--scene", "cornell_planes", "--width", "16", "--height", "16",
        "--spp", "2", "--bounces", "2", "--pool", "512", "--device", "cpu"]


def test_cli_sharded_world_of_one(tmp_path, capsys, monkeypatch):
    """Without torchrun's variables ``--sharded`` renders as a world of
    one: the unsharded image, bit for bit."""
    for v in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    a, b = tmp_path / "a.ppm", tmp_path / "b.ppm"
    assert cli.main(["render", *ARGS, "--sharded", "-o", str(a)]) == 0
    assert "wavefront iterations" in capsys.readouterr().out
    assert cli.main(["render", *ARGS, "-o", str(b)]) == 0
    np.testing.assert_array_equal(read_ppm(a), read_ppm(b))


def test_cli_sharded_under_torchrun(tmp_path):
    """Two CPU ranks under ``torchrun`` (gloo, ``env://``): rank 0 alone
    prints and writes the image."""
    out = tmp_path / "sharded.ppm"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "rtjax_torch", "render", *ARGS,
         "--sharded", "-o", str(out)], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count(f"wrote {out}") == 1
    assert read_ppm(out).shape == (16, 16, 3) and read_ppm(out).max() > 0
    assert os.listdir(tmp_path) == ["sharded.ppm"]
