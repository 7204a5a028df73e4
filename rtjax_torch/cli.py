"""Command-line interface (port of rtjax.cli): ``render`` and ``bench``
over the built-in scenes, with rtjax's flags and defaults, plus
``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
versions).

    python -m rtjax_torch render --scene cornell_bunny --width 600 \\
        --height 600 --spp 10 --bounces 10 -o image.ppm
    python -m rtjax_torch render --device cpu --width 32 --height 32 ...
    python -m rtjax_torch bench ...
    torchrun --nproc_per_node=N -m rtjax_torch render --sharded ...

``--sharded`` renders data-parallel over the sample space
(rtjax_torch.parallel): under ``torchrun``'s variables every process joins
one process group (NCCL on ``cuda:<LOCAL_RANK>``, gloo under ``--device
cpu``) and renders its share of the spp; without them it renders as a
world of one on ``--device``.  Rank 0 alone prints and writes the image.

The port's kernels build at first use into ``build/rtjax_torch/``; there
is no compile-cache step.
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_render_args(p):
    p.add_argument("--scene", default="cornell_bunny",
                   choices=["cornell_bunny", "cornell_planes",
                            "cornell_bunny_mirror", "cornell_bunny_glass"])
    p.add_argument("--width", type=int, default=600)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--bounces", type=int, default=10)
    p.add_argument("--pool", type=int, default=None,
                   help="wavefront path slots (default: adapted to the "
                        "workload)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--traversal", default="auto",
                   choices=["auto", "pallas", "xla"],
                   help="pallas: the traversal kernels over the wide "
                        "tables; xla: rtjax's binary-BVH walk (unsorted "
                        "engine); auto: the kernels")
    p.add_argument("--no-sort", action="store_true",
                   help="disable ray sorting before traversal")
    p.add_argument("--sharded", action="store_true",
                   help="data-parallel over the sample space: every process "
                        "that torchrun starts renders spp / N (a world of "
                        "one without torchrun)")
    p.add_argument("--reference-parity", action="store_true",
                   help="replicate the CUDA reference's estimator quirks "
                        "(see render/wavefront.py)")
    p.add_argument("--stats", action="store_true",
                   help="print detailed stats: bounce histogram + "
                        "traversal work counters")
    p.add_argument("--checkpoint", default=None, metavar="FILE.npz",
                   help="render in spp batches with checkpoint/resume")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("-o", "--output", default="image.ppm")


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False; pass --device cpu to render on the CPU")
    return dev


def _build_scene(name, device):
    from . import scenes
    if name == "cornell_planes":
        return scenes.cornell_planes(device)
    mat = "matte"
    if name.endswith("_mirror"):
        mat = "mirror"
    elif name.endswith("_glass"):
        mat = "glass"
    return scenes.cornell_bunny(device, bunny_material=mat)


def _mesh(args):
    """The mesh of ``--sharded``: the process group that ``torchrun``'s
    variables describe (joined here), else a world of one on
    ``--device``."""
    import os

    from .parallel import init_from_env, make_mesh
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return make_mesh(init_from_env(_device(args.device)))
    return make_mesh(_device(args.device))


def _config(args, **extra):
    from .config import RenderConfig
    return RenderConfig(width=args.width, height=args.height,
                        num_samples=args.spp, max_bounces=args.bounces,
                        num_working_paths=args.pool,
                        traversal=args.traversal,
                        sort_rays=not args.no_sort, seed=args.seed, **extra)


def cmd_render(args) -> int:
    if not args.sharded:
        return _render(args, None)
    import torch.distributed as dist
    mesh = _mesh(args)
    try:
        return _render(args, mesh)
    finally:
        if mesh.group is not None:
            dist.destroy_process_group()


def _render(args, mesh) -> int:
    """``render`` on ``--device``, or over ``mesh`` (``--sharded``): rank 0
    alone prints and writes the image."""
    import torch

    from .parallel import render_frame_sharded
    from .render import render_frame, write_ppm
    from .utils.profiler import profiler

    dev = _device(args.device) if mesh is None else mesh.device
    cfg = _config(args, reference_parity=args.reference_parity,
                  detailed_stats=args.stats)
    with profiler.phase("Building scene"):
        scene, camera = _build_scene(args.scene, dev)

    with profiler.phase("Rendering"):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        if args.checkpoint is not None:
            from .render.checkpoint import render_checkpointed
            fb = render_checkpointed(scene, camera, cfg, args.checkpoint,
                                     mesh=mesh)
            stats = None
        elif mesh is not None:
            fb, stats = render_frame_sharded(scene, camera, cfg, gen, mesh)
        else:
            fb, stats = render_frame(scene, camera, cfg, gen)
        fb = fb.cpu().numpy()
    if mesh is not None and mesh.rank != 0:
        return 0
    if stats is not None:
        print(f"{stats['iterations']} wavefront iterations, "
              f"{stats['rays_traced']:.4g} rays traced")
        if args.stats and "bounce_histogram" in stats:
            print(f"bounce histogram: {stats['bounce_histogram'].tolist()}")
            print(f"traversal: {stats['node_steps']} node steps, "
                  f"{stats['leaf_visits']} leaf visits")

    with profiler.phase("Writing image"):
        write_ppm(args.output, fb, args.width, args.height)
    print(f"wrote {args.output}")
    return 0


def cmd_bench(args) -> int:
    """Benchmark a built-in scene: report wall time and Mrays/s.  Each
    frame ends with a host read of the image."""
    import torch

    from .render import render_frame

    dev = _device(args.device)
    cfg = _config(args)
    scene, camera = _build_scene(args.scene, dev)
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fb, stats = render_frame(scene, camera, cfg, gen)
    _ = float(fb.cpu().numpy().mean())
    print(f"build+first run: {time.time() - t0:.1f}s")
    dt, rays = float("inf"), 0.0
    for rep in range(args.reps):
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(2 + rep)
        fb, stats = render_frame(scene, camera, cfg, gen)
        _ = float(fb.cpu().numpy().mean())
        rep_dt = time.time() - t0
        if rep_dt < dt:  # rays from the same rep as the least time
            dt = rep_dt
            rays = stats["rays_traced"]
    print(f"{args.scene} {cfg.width}x{cfg.height}@{cfg.num_samples}spp: "
          f"{dt:.3f}s, {rays:.4g} rays, {rays / dt / 1e6:.2f} Mrays/s")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtjax_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a built-in scene")
    _add_render_args(pr)
    pb = sub.add_parser("bench", help="benchmark a built-in scene")
    _add_render_args(pb)
    pb.add_argument("--reps", type=int, default=2,
                    help="timed repetitions (min is reported)")
    args = parser.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    return cmd_bench(args)


if __name__ == "__main__":
    sys.exit(main())
