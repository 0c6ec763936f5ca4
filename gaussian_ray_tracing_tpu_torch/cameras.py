"""Pinhole camera and primary-ray generation (counterpart of
gaussian_ray_tracing_tpu/cameras.py).

Reference camera semantics: W = lookat - eye (unnormalized, |W| is the
focal length), U = normalize(W x up) * ulen, V = normalize(U x W) * vlen
with vlen = |W| tan(fovY/2), ulen = vlen * aspect; the raygen negates U
and V, and pinhole rays are dir = normalize(d.x (-U) + d.y (-V) + W) for
the NDC pixel centre d. Fisheye and OpenCV cameras are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(_norm(v), min=eps)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Look-at camera: eye/lookat/up are (3,) float32 tensors on the render
    device; fov_y_deg, width and height are static."""

    eye: torch.Tensor
    lookat: torch.Tensor
    up: torch.Tensor
    fov_y_deg: float = 60.0
    width: int = 1280
    height: int = 720

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def device(self) -> torch.device:
        return self.eye.device

    @staticmethod
    def create(eye, lookat, up=(0.0, 1.0, 0.0), fov_y_deg=60.0, width=1280,
               height=720, device="cpu") -> "Camera":
        f32 = lambda v: torch.as_tensor(
            np.asarray(v, np.float32), dtype=torch.float32, device=device
        )
        return Camera(f32(eye), f32(lookat), f32(up), float(fov_y_deg),
                      int(width), int(height))

    def uvw_frame(self):
        """U, V, W (W unnormalized = focal length)."""
        W = self.lookat - self.eye
        wlen = _norm(W)[0]
        U = _normalize(torch.linalg.cross(W, self.up))
        V = _normalize(torch.linalg.cross(U, W))
        half = 0.5 * torch.deg2rad(
            torch.tensor(self.fov_y_deg, dtype=torch.float32, device=self.device)
        )
        vlen = wlen * torch.tan(half)
        ulen = vlen * self.aspect
        return U * ulen, V * vlen, W


def pixel_ndc(width: int, height: int, device="cpu") -> torch.Tensor:
    """(H, W, 2) NDC pixel centres d = 2*((px+0.5)/W, (py+0.5)/H) - 1,
    built on `device` with the same float32 operations as the JAX one."""
    f32 = dict(dtype=torch.float32, device=device)
    xs = (torch.arange(width, **f32) + 0.5) / width
    ys = (torch.arange(height, **f32) + 0.5) / height
    gx, gy = torch.meshgrid(2.0 * xs - 1.0, 2.0 * ys - 1.0, indexing="xy")
    return torch.stack([gx, gy], dim=-1)


def generate_rays(camera: Camera, config: RenderConfig):
    """All primary rays of a pinhole frame.

    Returns origins (H, W, 3), normalized dirs (H, W, 3) and valid (H, W).
    """
    if config.camera_model != CameraModel.PINHOLE or config.distortion:
        raise NotImplementedError(
            f"camera model {config.camera_model.value} is not ported yet"
        )
    U, V, W = camera.uvw_frame()
    d = pixel_ndc(camera.width, camera.height, camera.device)
    dx, dy = d[..., 0:1], d[..., 1:2]
    dirs = _normalize(dx * -U + dy * -V + W)
    valid = torch.ones(dirs.shape[:-1], dtype=torch.bool, device=dirs.device)
    origins = camera.eye.expand(dirs.shape)
    return origins, dirs, valid


def orbit_camera(center, radius: float, azimuth_deg: float, elevation_deg: float,
                 device="cpu", **kw) -> Camera:
    """Orbit camera around a scene centre (same pose math as the JAX one)."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    offset = np.array(
        [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)],
        dtype=np.float32,
    ) * radius
    center = np.asarray(center, np.float32)
    return Camera.create(eye=center + offset, lookat=center, device=device, **kw)
