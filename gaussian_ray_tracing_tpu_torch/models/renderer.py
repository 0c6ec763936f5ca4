"""Top-level rendering API (counterpart of
gaussian_ray_tracing_tpu/models/renderer.py).

`render()` picks the kernel path, the plain torch path, the tiled march
or the exact oracle, and the mesh tracer when a mesh is given, optionally
supersampled; `render_diff()` the same for the differentiable training
render; the stateful `GaussianRayTracer` holds the scene (on CUDA unless
told otherwise), frame size, camera, camera model and mesh primitives
(plane, sphere, OBJ), each with an optional material type.
Rolling-shutter frames are models/rolling.render_rolling (and
render_rolling_oracle).
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
    render_gpu, render_gpu_diff, snug_pair_capacity,
)
from gaussian_ray_tracing_tpu_torch.models.mesh_tracer import render_with_mesh
from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle
from gaussian_ray_tracing_tpu_torch.models.tiled import render_tiled
from gaussian_ray_tracing_tpu_torch.ops.tiles import count_pairs
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import (
    TriangleMesh, load_obj, make_plane, make_sphere, merge_meshes,
)

METHODS = ("auto", "gpu", "plain", "tiled", "oracle")


def render(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
           mesh=None, method: str = "auto", pair_capacity: int | None = None,
           return_aux: bool = False, supersample: int = 1):
    """Render a frame. method:
      "gpu"   -- the CUDA kernels; needs CUDA and CUDA tensors;
      "plain" -- the plain torch versions of the kernels, on any device;
      "auto"  -- "gpu" if the scene's tensors live on CUDA, else "plain"
                 (tensors are never moved between devices);
      "tiled" -- the tiled march (models/tiled.render_tiled): plain torch
                 on the scene's device, differentiable by autograd; its
                 binning's scan is kernel K2 on CUDA. Without a
                 pair_capacity the stream holds every pair; its aux counts
                 the pairs past config.max_per_tile in n_dropped;
      "oracle" -- the exact per-ray-sorted oracle (models/oracle.py), plain
                 torch on the scene's device; it bins no pairs, so its aux
                 is empty.
    With a mesh, the frame goes through the mesh tracer
    (models/mesh_tracer.render_with_mesh; "oracle": its exact oracle),
    whose aux holds block_dropped (planar path: none) and pair_dropped.

    supersample=N renders N x N rays per pixel (an (N W) x (N H) frame of
    the same camera) and box-filters them down: anti-aliasing for any
    camera model. The aux, if asked for, is the large frame's.
    """
    if supersample > 1:
        s = int(supersample)
        hi = Camera(eye=camera.eye, lookat=camera.lookat, up=camera.up,
                    fov_y_deg=camera.fov_y_deg, width=camera.width * s,
                    height=camera.height * s)
        out = render(scene, hi, config, mesh=mesh, method=method, pair_capacity=pair_capacity,
                     return_aux=return_aux)
        H, W = camera.height, camera.width
        out["rgb"] = out["rgb"].reshape(H, s, W, s, 3).mean(dim=(1, 3))
        out["alpha"] = out["alpha"].reshape(H, s, W, s).mean(dim=(1, 3))
        return out
    if mesh is not None:
        if method == "tiled":
            raise ValueError("the mesh tracer takes method auto, gpu, plain or oracle, "
                             "not tiled")
        if method == "oracle":
            out = render_with_mesh(scene, mesh, camera, config, oracle=True)
        else:
            out = render_with_mesh(scene, mesh, camera, config, pair_capacity=pair_capacity,
                                   use_kernels=_use_kernels(scene, method))
        if not return_aux:
            out.pop("aux")
        return out
    if method == "oracle":
        out = render_oracle(scene, camera, config)
        return {**out, "aux": {}} if return_aux else out
    if method == "tiled":
        return _render_tiled(scene, camera, config, pair_capacity, return_aux)
    return render_gpu(scene, camera, config, pair_capacity=pair_capacity,
                      return_aux=return_aux, use_kernels=_use_kernels(scene, method))


def render_diff(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
                method: str = "auto", pair_capacity: int | None = None):
    """Differentiable render (the training path; window or key order, other
    orders train as key, any camera model, SH degree 0-3): gradients reach
    the scene's means, scales, quats, opacities and sh through the
    hand-written backward K3, or with method="tiled" through torch
    autograd of the tiled march (JAX's use_pallas=False path). `method`
    as for render()."""
    if method == "tiled":
        return _render_tiled(scene, camera, config, pair_capacity)
    return render_gpu_diff(scene, camera, config, pair_capacity=pair_capacity,
                           use_kernels=_use_kernels(scene, method))


def _render_tiled(scene, camera, config, pair_capacity, return_aux=False):
    """render_tiled on a drop-free pair stream unless a capacity is given
    (the JAX default, 8 pairs a gaussian, drops pairs on dense frames)."""
    if pair_capacity is None:
        with torch.no_grad():
            pair_capacity = snug_pair_capacity(int(count_pairs(scene, camera, config)))
    return render_tiled(scene, camera, config, pair_capacity=pair_capacity,
                        return_aux=return_aux)


def _use_kernels(scene: GaussianScene, method: str) -> bool:
    if method == "auto":
        method = "gpu" if scene.device.type == "cuda" else "plain"
    if method == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError("method='gpu' needs CUDA, which is not available")
        return True
    if method == "plain":
        return False
    raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")


class GaussianRayTracer:
    """Stateful runtime: scene, frame size, camera, render.

    The scene lives on `device`: by default where `scene` already is, and
    on CUDA for a PLY path (device="cpu" loads it on the CPU); every camera
    is created there.
    """

    def __init__(self, ply_path: str | None = None, scene: GaussianScene | None = None,
                 config: RenderConfig = RenderConfig(), device=None):
        if scene is None:
            if ply_path is None:
                raise ValueError("need ply_path or scene")
            from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply

            scene = load_ply(ply_path, device=device or "cuda")
        elif device is not None:
            scene = scene.to(device)
        self.scene = scene
        self.device = scene.device
        self.config = config
        self.primitives: list[TriangleMesh] = []
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

    def set_camera_model(self, model: CameraModel | str):
        """Pinhole, fisheye or OpenCV (the distortion is config.distortion)."""
        if isinstance(model, str):
            model = CameraModel(model)
        self.config = self.config.replace(camera_model=model)

    # --- primitives (the reference's insert/remove/transform) ---
    def _spawn_position(self):
        """New primitives appear at 0.75 * eye + 0.25 * lookat."""
        return 0.75 * self.camera.eye.cpu().numpy() + 0.25 * self.camera.lookat.cpu().numpy()

    def _add(self, mesh: TriangleMesh, mesh_type) -> int:
        if mesh_type is not None:  # else follow the global config.mesh_type
            if isinstance(mesh_type, str):
                mesh_type = MeshType[mesh_type.upper()]
            mesh = mesh.with_type(mesh_type)
        self.primitives.append(mesh)
        return len(self.primitives) - 1

    def create_plane(self, mesh_type: MeshType | str | None = None) -> int:
        """Insert a plane; mesh_type pins this primitive's material
        independently of the global render type."""
        return self._add(make_plane(self._spawn_position(), device=self.device), mesh_type)

    def create_sphere(self, tess_u: int = 180, tess_v: int = 90,
                      mesh_type: MeshType | str | None = None) -> int:
        return self._add(make_sphere(self._spawn_position(), tess_u=tess_u, tess_v=tess_v,
                                     device=self.device), mesh_type)

    def create_load_mesh(self, path: str, mesh_type: MeshType | str | None = None) -> int:
        return self._add(load_obj(path, self._spawn_position(), device=self.device), mesh_type)

    def update_instance_transform(self, index: int, transform):
        self.primitives[index] = self.primitives[index].with_transform(transform)

    def remove_primitive(self, index: int):
        self.primitives.pop(index)

    def set_render_type(self, mesh_type: MeshType | str):
        if isinstance(mesh_type, str):
            mesh_type = MeshType[mesh_type.upper()]
        self.config = self.config.replace(mesh_type=mesh_type)

    def render(self, method: str = "auto", supersample: int = 1):
        """Render the current frame. The pair capacity is bucketed from the
        previous frame's pair count (the next power of two above 1.3x), so
        static scenes reuse one allocation size; a frame that outgrows the
        bucket is rebuilt at a snug capacity rather than dropping pairs.
        With primitives, their merged mesh goes through the mesh tracer.
        The oracle bins no pairs and leaves the bucket as it is."""
        if self.primitives or method == "oracle":
            mesh = merge_meshes(self.primitives) if self.primitives else None
            return render(self.scene, self.camera, self.config, mesh=mesh, method=method,
                          supersample=supersample)
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
