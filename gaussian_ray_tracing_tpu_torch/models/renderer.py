"""Top-level rendering API (counterpart of
gaussian_ray_tracing_tpu/models/renderer.py).

`render()` picks the kernel path or the plain torch path; the stateful
`GaussianRayTracer` holds the scene, frame size and camera. Mesh
primitives and supersampling are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import render_gpu
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

METHODS = ("auto", "gpu", "plain")


def render(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
           mesh=None, method: str = "auto", pair_capacity: int | None = None,
           return_aux: bool = False, supersample: int = 1):
    """Render a frame. method:
      "gpu"   -- the CUDA kernels; needs CUDA and CUDA tensors;
      "plain" -- the plain torch versions of the kernels, on any device;
      "auto"  -- "gpu" if the scene's tensors live on CUDA, else "plain"
                 (tensors are never moved between devices).
    """
    if mesh is not None:
        raise NotImplementedError("mesh bounces are not ported yet")
    if supersample != 1:
        raise NotImplementedError("supersampling is not ported yet")
    if method == "auto":
        method = "gpu" if scene.device.type == "cuda" else "plain"
    if method == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError("method='gpu' needs CUDA, which is not available")
        use_kernels = True
    elif method == "plain":
        use_kernels = False
    else:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    return render_gpu(scene, camera, config, pair_capacity=pair_capacity,
                      return_aux=return_aux, use_kernels=use_kernels)


class GaussianRayTracer:
    """Stateful runtime: scene, frame size, camera, render.

    The scene lives on `device` (default: where `scene` already is, or the
    CPU for a PLY path); every camera is created there.
    """

    def __init__(self, ply_path: str | None = None, scene: GaussianScene | None = None,
                 config: RenderConfig = RenderConfig(), device=None):
        if scene is None:
            if ply_path is None:
                raise ValueError("need ply_path or scene")
            from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply

            scene = load_ply(ply_path, device=device or "cpu")
        elif device is not None:
            scene = scene.to(device)
        self.scene = scene
        self.device = scene.device
        self.config = config
        # pair-capacity bucket, refreshed from observed pair counts
        self._pair_capacity: int | None = None
        self.width = 1280
        self.height = 720
        self.camera = Camera.create(
            eye=(0.0, 0.0, 3.0), lookat=scene.center().cpu().numpy(),
            width=self.width, height=self.height, device=self.device,
        )

    def set_size(self, width: int, height: int):
        self.width, self.height = width, height
        c = self.camera
        self.camera = Camera.create(
            eye=c.eye.cpu().numpy(), lookat=c.lookat.cpu().numpy(), up=c.up.cpu().numpy(),
            fov_y_deg=c.fov_y_deg, width=width, height=height, device=self.device,
        )

    def update_camera(self, camera: Camera):
        self.camera = camera

    def create_plane(self, mesh_type=None) -> int:
        raise NotImplementedError("mesh primitives are not ported yet")

    def create_sphere(self, tess_u: int = 180, tess_v: int = 90, mesh_type=None) -> int:
        raise NotImplementedError("mesh primitives are not ported yet")

    def create_load_mesh(self, path: str, mesh_type=None) -> int:
        raise NotImplementedError("mesh primitives are not ported yet")

    def render(self, method: str = "auto", supersample: int = 1):
        """Render the current frame. The pair capacity is bucketed from the
        previous frame's pair count (the next power of two above 1.3x), so
        static scenes reuse one allocation size; a frame that outgrows the
        bucket is rebuilt at a snug capacity rather than dropping pairs."""
        out = render(self.scene, self.camera, self.config, method=method,
                     pair_capacity=self._pair_capacity, return_aux=True,
                     supersample=supersample)
        n = out.pop("aux")["n_pairs"]
        self._pair_capacity = 1 << max(16, int(n * 1.3).bit_length())
        return out

    def render_rgb8(self, method: str = "auto", supersample: int = 1) -> np.ndarray:
        """RGB8-quantized frame."""
        from gaussian_ray_tracing_tpu_torch.utils.image import quantize_rgb8

        out = self.render(method=method, supersample=supersample)
        return quantize_rgb8(out["rgb"].cpu().numpy())
