"""rtjax_torch's checkpointed spp batches (render/checkpoint.py), after
rtjax's test_checkpoint_resume: resume equals an uninterrupted run bit for
bit on the CPU, the fingerprint refuses another scene, camera or
configuration, and a configuration whose full camera-ray count overflows
int32 still checkpoints when its batches fit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rtjax_torch import RenderConfig
from rtjax_torch.parallel import Mesh
from rtjax_torch.render.checkpoint import (batch_generator,
                                           render_checkpointed,
                                           render_fingerprint)
from rtjax_torch.render.wavefront import render_frame_linear
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder
from rtjax_torch.scene.transform import Transform, scale, translate

PYRAMID_V = np.array([[0, 0, 0], [0.2, 0, 0], [0.1, 0, -0.2],
                      [0.1, 0.25, -0.07]])
PYRAMID_F = np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3], [0, 1, 2]])


def _scene(nudge=0.0):
    """rtjax's test_features._scene (baked placements); ``nudge`` moves one
    vertex of the floor."""
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    red = b.make_matte((0.65, 0.05, 0.05))
    b.add_triangles([0, 0, 0], [1 + nudge, 0, 0], [1, 0, -1], white)
    b.add_triangles([0, 0, 0], [0, 0, -1], [1, 0, -1], white)
    b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3], [0.7, 0.9, -0.7],
                     (10, 10, 10), white)
    for t in (Transform(translate(0.2, 0, -0.3)),
              Transform(scale(1.5, 1.5, 1.5)).composite(
                  translate(0.55, 0, -0.55))):
        b.add_mesh(PYRAMID_V, PYRAMID_F, red, transform=t)
    return b.build("cpu")


def _cam(x=0.5):
    return Camera.make((x, 0.6, 1.2), (0.5, 0.2, -0.4), (0, 1, 0), 45, 1.0,
                       device="cpu")


CFG = RenderConfig(width=16, height=16, num_samples=16, max_bounces=2,
                   num_working_paths=1024)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def test_checkpoint_resume_is_bitwise(scene, tmp_path):
    path = str(tmp_path / "ck.npz")
    full = render_checkpointed(scene, _cam(), CFG, path=None, batch_spp=4,
                               verbose=False)
    # 2 of 4 batches ("crash"), then resume
    render_checkpointed(scene, _cam(), dataclasses.replace(CFG,
                                                           num_samples=8),
                        path=path, batch_spp=4, verbose=False)
    with np.load(path) as ck:
        assert int(ck["batches_done"]) == 2
        assert int(ck["batch_spp"]) == 4 and int(ck["seed"]) == CFG.seed
        assert str(ck["fingerprint"]) == render_fingerprint(scene, _cam(),
                                                            CFG)
        assert ck["fb"].shape == (CFG.num_pixels, 3)
    resumed = render_checkpointed(scene, _cam(), CFG, path=path, batch_spp=4,
                                  verbose=False)
    assert torch.equal(resumed, full)
    assert not os.path.exists(path + ".tmp")
    with np.load(path) as ck:
        assert int(ck["batches_done"]) == 4


def test_batches_are_the_seeded_frames(scene):
    """The checkpointed image is the sum of the per-batch frames, each
    drawn from its own seeded generator."""
    got = render_checkpointed(scene, _cam(), CFG, path=None, batch_spp=8,
                              verbose=False)
    cfg = dataclasses.replace(CFG, num_samples=8)
    fb = sum(render_frame_linear(scene, _cam(), cfg,
                                 batch_generator(CFG.seed, b, "cpu"))[0]
             for b in range(2))
    assert torch.equal(got, torch.sqrt(fb / CFG.num_samples))
    a = torch.randint(0, 1 << 30, (4,), generator=batch_generator(1, 0,
                                                                  "cpu"))
    b = torch.randint(0, 1 << 30, (4,), generator=batch_generator(1, 1,
                                                                  "cpu"))
    c = torch.randint(0, 1 << 30, (4,), generator=batch_generator(2, 0,
                                                                  "cpu"))
    assert not torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("change", ["vertex", "camera", "max_bounces",
                                    "seed", "batch_spp"])
def test_mismatched_checkpoint_starts_fresh(scene, tmp_path, change):
    path = str(tmp_path / "ck.npz")
    render_checkpointed(scene, _cam(), dataclasses.replace(CFG,
                                                           num_samples=8),
                        path=path, batch_spp=4, verbose=False)
    sc, cam, cfg, bs = scene, _cam(), CFG, 4
    if change == "vertex":
        sc = _scene(nudge=1e-3)
    elif change == "camera":
        cam = _cam(0.5 + 1e-3)
    elif change == "max_bounces":
        cfg = dataclasses.replace(CFG, max_bounces=3)
    elif change == "seed":
        cfg = dataclasses.replace(CFG, seed=CFG.seed + 1)
    else:
        bs = 8
    if change in ("vertex", "camera", "max_bounces", "seed"):
        assert render_fingerprint(sc, cam, cfg) != \
            render_fingerprint(scene, _cam(), CFG)
    fresh = render_checkpointed(sc, cam, cfg, path=None, batch_spp=bs,
                                verbose=False)
    got = render_checkpointed(sc, cam, cfg, path=path, batch_spp=bs,
                              verbose=False)
    assert torch.equal(got, fresh)   # nothing of the stale file was added


def test_fingerprint_is_content_only(scene):
    """Two builds of one scene give one fingerprint; it reads bytes, so a
    copy of the tensors elsewhere hashes the same."""
    assert render_fingerprint(scene, _cam(), CFG) == \
        render_fingerprint(_scene(), _cam(), CFG)
    assert render_fingerprint(scene, _cam(), CFG) == render_fingerprint(
        scene, _cam(), dataclasses.replace(CFG, num_samples=1024,
                                           num_working_paths=None))


def test_overflowing_config_checkpoints_by_batches(scene, tmp_path):
    """256x256 at 2^15 spp is 2^31 camera rays, past int32 ray ids: the
    full config cannot size itself, but a file one 1-spp batch short of
    done finishes with one batch's render."""
    cfg = RenderConfig(width=256, height=256, num_samples=1 << 15,
                       max_bounces=1, num_working_paths=1 << 14)
    with pytest.raises(ValueError, match="overflow int32"):
        cfg.total_camera_rays
    path = str(tmp_path / "big.npz")
    prev = np.full((cfg.num_pixels, 3), 2.0, np.float32)
    np.savez(path, fb=prev, batches_done=(1 << 15) - 1, seed=cfg.seed,
             batch_spp=1, fingerprint=render_fingerprint(scene, _cam(), cfg))
    got = render_checkpointed(scene, _cam(), cfg, path=path, batch_spp=1,
                              verbose=False)
    last, _ = render_frame_linear(
        scene, _cam(), dataclasses.replace(cfg, num_samples=1),
        batch_generator(cfg.seed, (1 << 15) - 1, "cpu"))
    assert torch.equal(got, torch.sqrt((torch.tensor(prev) + last)
                                       / cfg.num_samples))
    with np.load(path) as ck:
        assert int(ck["batches_done"]) == 1 << 15


def test_bad_batches_and_mesh_raise(scene):
    with pytest.raises(ValueError, match="divide"):
        render_checkpointed(scene, _cam(), CFG, None, batch_spp=5,
                            verbose=False)
    with pytest.raises(TypeError, match="Mesh"):
        render_checkpointed(scene, _cam(), CFG, None, mesh=object(),
                            verbose=False)
    with pytest.raises(ValueError, match="mesh size 3"):
        render_checkpointed(scene, _cam(), CFG, None, batch_spp=4,
                            mesh=Mesh(None, 3, 0, torch.device("cpu")),
                            verbose=False)
