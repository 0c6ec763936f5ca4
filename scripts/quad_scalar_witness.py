#!/usr/bin/env python3
"""Quad against scalar response in window and key order, in both packages,
on the CPU: JAX's render_pallas(quad=True) against render_pallas(quad=False)
(Pallas in interpret mode) and the port's render_gpu(quad=True) against
render_gpu(quad=False) (plain torch versions of K1 and K2), on the same
random_scene(n, seed=0) and camera (eye (0, 0.2, 2.6), bench config:
hit_multiplicity 1, march_chunk 128). Prints, per order, each package's
quad-vs-scalar PSNR and max abs, and the port against JAX per response.

    JAX_PLATFORMS=cpu python scripts/quad_scalar_witness.py 40000 96 64 window,key

A dense frame (40k gaussians at 96x64 takes ~70 s) shows the window-order
gap that a sparse one (5k at 128x96) does not.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera  # noqa: E402
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig  # noqa: E402
from gaussian_ray_tracing_tpu.models.pallas_renderer import render_pallas  # noqa: E402
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene  # noqa: E402
from gaussian_ray_tracing_tpu_torch.cameras import Camera  # noqa: E402
from gaussian_ray_tracing_tpu_torch.config import RenderConfig  # noqa: E402
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import render_gpu  # noqa: E402
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene  # noqa: E402
from gaussian_ray_tracing_tpu_torch.utils.image import psnr  # noqa: E402


def main() -> None:
    n, width, height = (int(x) for x in sys.argv[1:4])
    orders = sys.argv[4].split(",") if len(sys.argv) > 4 else ["window", "key"]
    cam = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=width, height=height)
    jscene, scene = j_random_scene(n, seed=0), random_scene(n, seed=0)
    for order in orders:
        kw = dict(hit_multiplicity=1, order=order, march_chunk=128)
        t0 = time.time()
        jax_rgb = {q: np.asarray(render_pallas(jscene, JCamera.create(**cam), JConfig(**kw),
                                               pair_capacity=2_000_000, interpret=True,
                                               quad=q)["rgb"]) for q in (True, False)}
        port_rgb = {q: render_gpu(scene, Camera.create(**cam), RenderConfig(**kw),
                                  use_kernels=False, quad=q)["rgb"].numpy() for q in (True, False)}
        gap = lambda d: (psnr(d[True], d[False]), float(np.abs(d[True] - d[False]).max()))
        (jp, jm), (tp, tm) = gap(jax_rgb), gap(port_rgb)
        print(f"{order} {n} {width}x{height}: jax quad-vs-scalar {jp:.2f} dB max abs {jm:.3g} | "
              f"port {tp:.2f} dB max abs {tm:.3g} | port vs jax: quad "
              f"{psnr(port_rgb[True], jax_rgb[True]):.2f} dB, scalar "
              f"{psnr(port_rgb[False], jax_rgb[False]):.2f} dB ({time.time() - t0:.0f} s)",
              flush=True)


if __name__ == "__main__":
    main()
