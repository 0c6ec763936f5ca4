"""NeRF-synthetic / Blender multi-view datasets (counterpart of
gaussian_ray_tracing_tpu/scene/dataset.py).

Loads `transforms_<split>.json` and its PNG frames into (Camera, target
image) pairs for train.Trainer.fit. The JAX version reads and resizes the
frames with PIL; the port uses utils/image.read_png and resize_lanczos
(PIL's LANCZOS resize, reproduced), so it needs only numpy and zlib.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.utils.image import read_png, resize_lanczos


def _camera_from_c2w(c2w: np.ndarray, fov_y_deg: float, width: int, height: int,
                     device="cpu") -> Camera:
    """NeRF/Blender camera-to-world (OpenGL: looks down -Z, +Y up)."""
    eye = c2w[:3, 3]
    return Camera.create(eye=eye, lookat=eye - c2w[:3, 2], up=c2w[:3, 1], fov_y_deg=fov_y_deg,
                         width=width, height=height, device=device)


def load_nerf_synthetic(root: str, split: str = "train", downscale: int = 1,
                        white_background: bool = True, max_views: int | None = None,
                        device="cuda"):
    """Load `<root>/transforms_<split>.json` (or plain transforms.json).

    Returns (views, meta): views = list[(Camera, (H, W, 3) float32 tensor in
    [0, 1])] on `device`; meta = {"center": (3,), "extent": float} from the
    camera positions. `device` defaults to CUDA and raises without it.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_nerf_synthetic(device='cuda') needs CUDA, which is not "
                           "available; pass device='cpu'")
    path = os.path.join(root, f"transforms_{split}.json")
    if not os.path.exists(path):
        path = os.path.join(root, "transforms.json")
    with open(path) as f:
        meta_json = json.load(f)
    cam_angle_x = float(meta_json["camera_angle_x"])
    frames = meta_json["frames"]
    if max_views is not None:
        frames = frames[:max_views]
    views, eyes = [], []
    for fr in frames:
        img_path = os.path.join(root, fr["file_path"])
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        img = read_png(img_path)
        if downscale > 1:
            img = resize_lanczos(img, img.shape[1] // downscale, img.shape[0] // downscale)
        arr = img.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.shape[-1] == 4:
            rgb, a = arr[..., :3], arr[..., 3:4]
            bg = 1.0 if white_background else 0.0
            arr = rgb * a + bg * (1.0 - a)
        H, W = arr.shape[:2]
        fov_y = np.degrees(2.0 * np.arctan(np.tan(cam_angle_x / 2.0) * H / W))
        c2w = np.asarray(fr["transform_matrix"], np.float32)
        views.append((_camera_from_c2w(c2w, float(fov_y), W, H, device),
                      torch.as_tensor(np.ascontiguousarray(arr[..., :3]), device=device)))
        eyes.append(c2w[:3, 3])
    eyes = np.stack(eyes)
    center = eyes.mean(axis=0)
    extent = float(np.linalg.norm(eyes - center, axis=-1).max())
    return views, {"center": center, "extent": extent}
