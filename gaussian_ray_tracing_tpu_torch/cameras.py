"""Cameras and primary-ray generation (counterpart of
gaussian_ray_tracing_tpu/cameras.py): pinhole, equisolid fisheye, OpenCV
distortion and rolling shutter.

Reference camera semantics: W = lookat - eye (unnormalized, |W| is the
focal length), U = normalize(W x up) * ulen, V = normalize(U x W) * vlen
with vlen = |W| tan(fovY/2), ulen = vlen * aspect; the raygen negates U
and V, and pinhole rays are dir = normalize(d.x (-U) + d.y (-V) + W) for
the NDC pixel centre d. Fisheye rays are equisolid, r = 2 f sin(theta/2)
with f = config.fisheye_focal; pixels with r > 1 have no ray (zero
direction, valid False) and are blanked. OPENCV undistorts the normalized
camera coordinates d * tan(fov/2) before the pinhole map. Rolling shutter
exposes row y at t = y / (H - 1) of a pose lerped from cam0 to cam1.
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


def _coeffs(dist: tuple) -> tuple:
    """(k1, k2, p1, p2, k3, k4, k5, k6), missing ones zero."""
    return (tuple(dist) + (0.0,) * 8)[:8]


def distort_opencv(x: torch.Tensor, y: torch.Tensor, dist: tuple):
    """Forward OpenCV distortion of normalized camera coordinates (x = X/Z);
    dist = (k1, k2, p1, p2[, k3[, k4, k5, k6]])."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(dist)
    r2 = x * x + y * y
    num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    cdist = num / den
    xy2 = 2.0 * x * y
    xd = x * cdist + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * cdist + p1 * (r2 + 2.0 * y * y) + p2 * xy2
    return xd, yd


def undistort_opencv(xd: torch.Tensor, yd: torch.Tensor, dist: tuple, iters: int = 8):
    """Invert distort_opencv by `iters` fixed-point steps (the
    cv2.undistortPoints scheme): ideal = (distorted - tangential) / cdist."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(dist)
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        num = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
        den = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        icdist = num / torch.clamp(den, min=1e-9)
        xy2 = 2.0 * x * y
        dx = p1 * xy2 + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + p2 * xy2
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    return x, y


def _fisheye_local(dx: torch.Tensor, dy: torch.Tensor, config: RenderConfig):
    """Equisolid local directions (sin t cos p, sin t sin p, cos t) of the
    NDC coordinates and the mask r <= 1 of the pixels that have a ray."""
    r = torch.sqrt(dx * dx + dy * dy)
    valid = r <= 1.0
    two_f = torch.full_like(r, 2.0 * config.fisheye_focal)
    theta = 2.0 * torch.asin(torch.clamp(r / two_f, -1.0, 1.0))
    phi = torch.atan2(dy, dx)
    st, ct = torch.sin(theta), torch.cos(theta)
    return (st * torch.cos(phi), st * torch.sin(phi), ct), valid


def generate_rays(camera: Camera, config: RenderConfig):
    """All primary rays of a frame.

    Returns origins (H, W, 3), dirs (H, W, 3) normalized (zero where no ray
    exists) and valid (H, W) (False for fisheye pixels with r > 1).
    """
    U, V, W = camera.uvw_frame()
    d = pixel_ndc(camera.width, camera.height, camera.device)
    dx, dy = d[..., 0], d[..., 1]
    valid = torch.ones(dx.shape, dtype=torch.bool, device=dx.device)
    if config.camera_model == CameraModel.PINHOLE:
        dirs = _normalize(dx[..., None] * -U + dy[..., None] * -V + W)
    elif config.camera_model == CameraModel.OPENCV:
        wlen = _norm(W)[0]
        cu, cv = _norm(U)[0] / wlen, _norm(V)[0] / wlen
        xi, yi = undistort_opencv(dx * cu, dy * cv, config.distortion)
        dirs = _normalize((xi / cu)[..., None] * -U + (yi / cv)[..., None] * -V + W)
    elif config.camera_model == CameraModel.FISHEYE:
        (lx, ly, lz), valid = _fisheye_local(dx, dy, config)
        dirs = lx[..., None] * -U + ly[..., None] * -V + lz[..., None] * W
        dirs = torch.where(valid[..., None], _normalize(dirs), 0.0)
    else:
        raise ValueError(f"unknown camera model {config.camera_model}")
    origins = camera.eye.expand(dirs.shape)
    return origins, dirs, valid


def lerp_camera(cam0: Camera, cam1: Camera, t: float) -> Camera:
    """Linear pose interpolation (small inter-frame motion)."""
    lerp = lambda a, b: a + t * (b - a)
    return Camera(eye=lerp(cam0.eye, cam1.eye), lookat=lerp(cam0.lookat, cam1.lookat),
                  up=lerp(cam0.up, cam1.up), fov_y_deg=cam0.fov_y_deg,
                  width=cam0.width, height=cam0.height)


def generate_rays_rolling(cam0: Camera, cam1: Camera, config: RenderConfig):
    """Rolling-shutter primary rays: row y is exposed at t = y / (H - 1) of
    the pose lerped cam0 -> cam1, each scalar of the UVW frame an (H,) row.

    Returns origins (H, W, 3), dirs (H, W, 3) normalized and valid (H, W).
    """
    H, Wd = cam0.height, cam0.width
    dev = cam0.device
    # jnp.linspace(0, 1, H): i / (H - 1) as a true division, 1 at the end
    t = (torch.arange(H, dtype=torch.float32, device=dev)
         / torch.tensor(float(max(H - 1, 1)), device=dev))[:, None]
    eye = cam0.eye[None] + t * (cam1.eye - cam0.eye)[None]  # (H, 3)
    lookat = cam0.lookat[None] + t * (cam1.lookat - cam0.lookat)[None]
    up = cam0.up[None] + t * (cam1.up - cam0.up)[None]

    W = lookat - eye
    wlen = _norm(W)  # (H, 1)
    U = _normalize(torch.linalg.cross(W, up))
    V = _normalize(torch.linalg.cross(U, W))
    half = 0.5 * torch.deg2rad(torch.tensor(cam0.fov_y_deg, dtype=torch.float32, device=dev))
    vlen = wlen * torch.tan(half)
    U = U * (vlen * cam0.aspect)
    V = V * vlen

    d = pixel_ndc(Wd, H, dev)
    dx, dy = d[..., 0], d[..., 1]  # (H, W)
    Ur, Vr, Wr = -U[:, None, :], -V[:, None, :], W[:, None, :]
    if config.camera_model == CameraModel.FISHEYE:
        (lx, ly, lz), valid = _fisheye_local(dx, dy, config)
        dirs = lx[..., None] * Ur + ly[..., None] * Vr + lz[..., None] * Wr
        dirs = torch.where(valid[..., None], _normalize(dirs), 0.0)
        return eye[:, None, :].expand(dirs.shape), dirs, valid
    if config.camera_model == CameraModel.OPENCV:
        cu = _norm(U)[:, 0] / wlen[:, 0]
        cv = _norm(V)[:, 0] / wlen[:, 0]
        xi, yi = undistort_opencv(dx * cu[:, None], dy * cv[:, None], config.distortion)
        dx, dy = xi / cu[:, None], yi / cv[:, None]
    dirs = _normalize(dx[..., None] * Ur + dy[..., None] * Vr + Wr)
    valid = torch.ones(dirs.shape[:-1], dtype=torch.bool, device=dev)
    return eye[:, None, :].expand(dirs.shape), dirs, valid


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
