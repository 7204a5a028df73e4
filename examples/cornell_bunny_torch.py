"""The reference demo through rtjax_torch, the PyTorch + CUDA port.

The Stanford bunny (matte brown) in a Cornell box with a 2-triangle area
light (L = 15), rendered at 600x600 @ 10 spp, max 10 bounces, written as
ASCII PPM: the demo of examples/cornell_bunny.py, rendered by the port.

Run:  python examples/cornell_bunny_torch.py [out.ppm] [--device cpu]
(the default device is cuda).
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtjax_torch import RenderConfig  # noqa: E402
from rtjax_torch.render import render_frame, write_ppm  # noqa: E402
from rtjax_torch.scenes import cornell_bunny  # noqa: E402
from rtjax_torch.utils.profiler import profiler  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default="image.ppm")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu to render on the CPU")

    with profiler.phase("Building scene (PLY + transform + BVH)"):
        scene, camera = cornell_bunny(dev)
    print(f"{scene.tris.num} triangles, {scene.bvh.num_nodes} BVH nodes, "
          f"{scene.num_lights} lights")

    cfg = RenderConfig(width=600, height=600, num_samples=10, max_bounces=10,
                       num_working_paths=1 << 17)
    with profiler.phase("Rendering"):
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        fb, stats = render_frame(scene, camera, cfg, gen)
        fb = fb.cpu().numpy()
    print(f"{stats['iterations']} iterations, {stats['rays_traced']:.4g} "
          "rays")

    with profiler.phase("Writing image"):
        write_ppm(args.out, fb, cfg.width, cfg.height)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
