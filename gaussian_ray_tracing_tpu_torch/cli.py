"""Command-line interface of the port (the `render` subcommand of
gaussian_ray_tracing_tpu/cli.py, pinhole only).

    python -m gaussian_ray_tracing_tpu_torch.cli render --synthetic 100000 \
        --width 1280 --height 720 -o out.png
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _build(args):
    from gaussian_ray_tracing_tpu_torch.cameras import Camera
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    device = args.device
    if device == "auto":
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.ply:
        from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply

        scene = load_ply(args.ply, device=device)
    else:
        scene = random_scene(args.synthetic or 100_000, seed=args.seed, device=device)
    cfg = RenderConfig(hit_multiplicity=args.hit_multiplicity)
    if args.march_chunk:
        cfg = cfg.replace(march_chunk=args.march_chunk)
    tracer = GaussianRayTracer(scene=scene, config=cfg)
    tracer.set_size(args.width, args.height)
    center = scene.center().cpu().numpy()
    eye = np.asarray(args.eye) if args.eye else center + np.array([0.0, 0.0, 3.0])
    lookat = np.asarray(args.lookat) if args.lookat else center
    tracer.update_camera(Camera.create(eye=eye, lookat=lookat, fov_y_deg=args.fov,
                                       width=args.width, height=args.height,
                                       device=scene.device))
    return tracer


def cmd_render(args):
    from gaussian_ray_tracing_tpu_torch.utils.image import write_png

    frame = _build(args).render_rgb8(method=args.method)
    write_png(args.output, frame)
    print(f"wrote {args.output} ({frame.shape[1]}x{frame.shape[0]})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grt-torch", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render one pinhole frame to PNG")
    p.add_argument("-p", "--ply", type=str, default=None, help="trained 3DGS PLY")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="use a seeded synthetic scene with N gaussians")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--hit-multiplicity", type=int, default=2,
                   help="2 = reference proxy-hull double-hit compositing; "
                        "1 = standard volume rendering")
    p.add_argument("--march-chunk", type=int, default=None,
                   help="march chunk / ordering window width")
    p.add_argument("--method", choices=["auto", "gpu", "plain"], default="auto")
    p.add_argument("--device", default="auto",
                   help="auto (cuda when available, else cpu), cuda, cpu, ...")
    p.add_argument("-o", "--output", type=str, default="render.png")
    p.set_defaults(func=cmd_render)
    args = ap.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
