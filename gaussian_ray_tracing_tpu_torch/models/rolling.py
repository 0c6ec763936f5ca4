"""Rolling-shutter rendering on the port's kernels (counterpart of
gaussian_ray_tracing_tpu/models/rolling.py, `render_rolling_pallas`).

Row y of the frame is exposed at t = y / (H - 1) of the pose lerped cam0
-> cam1 (cameras.generate_rays_rolling), so every ray has its own origin.
Binning is conservative under motion: each gaussian's rect is the union
of its exact footprints at cam0, the midpoint and cam1, binned on the
midpoint camera with the midpoint pose's central-ray depth key. The march
is kernel K1 in its per-ray-origin scalar mode over the pair stream (no
block list), on the scalar rows of ops/march.scalar_features, at any SH
degree 0 to 3. `render_rolling_oracle` is the exact per-ray oracle of the
same rays (models/oracle.py), plain torch on the scene's device.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays_rolling, lerp_camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig, check_supported, chunk_for
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
    bin_footprints, check_devices, frame_image, snug_pair_capacity,
)
from gaussian_ray_tracing_tpu_torch.models.oracle import frame_from_rays, render_rays_oracle
from gaussian_ray_tracing_tpu_torch.models.tiled import depth_key, feature_table, tile_rays
from gaussian_ray_tracing_tpu_torch.ops.march import (
    march, march_plain, scalar_features, train_features,
)
from gaussian_ray_tracing_tpu_torch.ops.tiles import (
    Footprint, footprint_pair_count, project_footprints_conic,
)
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene


def _union_footprints(scene: GaussianScene, radius, bound_radius, cams,
                      config: RenderConfig) -> Footprint:
    """Union rect of the exact footprints at each pose of `cams`; the depth
    is the middle pose's."""
    fps = [project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                    bound_radius, cam, config) for cam in cams]
    x0 = torch.stack([fp.px - fp.rx for fp in fps]).amin(dim=0)
    x1 = torch.stack([fp.px + fp.rx for fp in fps]).amax(dim=0)
    y0 = torch.stack([fp.py - fp.ry for fp in fps]).amin(dim=0)
    y1 = torch.stack([fp.py + fp.ry for fp in fps]).amax(dim=0)
    return Footprint(px=0.5 * (x0 + x1), py=0.5 * (y0 + y1), rx=0.5 * (x1 - x0),
                     ry=0.5 * (y1 - y0), depth=fps[len(fps) // 2].depth,
                     visible=torch.stack([fp.visible for fp in fps]).any(dim=0))


def prepare_rolling_stream(scene: GaussianScene, cam0: Camera, cam1: Camera,
                           config: RenderConfig, pair_capacity: int | None = None,
                           use_kernels: bool = True, train: bool = False):
    """Union footprints and the midpoint depth key -> the pair stream on
    the midpoint camera -> per-pair scalar rows (train: the training rows
    of ops/march.train_features, whose view-independent Q columns the
    per-ray-origin quad response reads and whose diff columns keep autograd
    for march_stream_diff), and the tiled rays. Binning carries no
    gradient, and bins without the scene's geometry, as JAX's rolling
    shutter does (models/rolling.py:115): config.pair_keys is not applied.
    Returns (starts, rows, dirs_t, origins_t, valid, n_pairs)."""
    cam_mid = lerp_camera(cam0, cam1, 0.5)
    table, M, radius = feature_table(scene, config, eye=cam_mid.eye if train else None)
    M, radius = M.detach(), radius.detach()
    fixed = GaussianScene(*(getattr(scene, k).detach()
                            for k in ("means", "scales", "quats", "opacities", "sh")),
                          num_active=scene.num_active)
    bound_radius = radius * torch.amax(fixed.scales, dim=-1)
    fp = _union_footprints(fixed, radius, bound_radius, (cam0, cam_mid, cam1), config)
    fp = fp._replace(depth=depth_key(fixed, M, radius, cam_mid.eye, config))
    if pair_capacity is None:
        pair_capacity = snug_pair_capacity(int(footprint_pair_count(fp, cam_mid, config)))
    stream, ids, n_pairs = bin_footprints(fp, cam_mid, config, pair_capacity, use_kernels)
    rows = (train_features if train else scalar_features)(table, config.sh_degree)[ids]
    origins, dirs, valid = generate_rays_rolling(cam0, cam1, config)
    dirs_t = tile_rays(dirs, config.tile_w, config.tile_h)
    origins_t = tile_rays(origins, config.tile_w, config.tile_h)
    return stream.starts, rows, dirs_t, origins_t, valid, n_pairs


def render_rolling(scene: GaussianScene, cam0: Camera, cam1: Camera,
                   config: RenderConfig = RenderConfig(), pair_capacity: int | None = None,
                   return_aux: bool = False, use_kernels: bool = True):
    """Rolling-shutter frame: {rgb (H, W, 3) in [0, 1], alpha (H, W)} and,
    with return_aux, {"aux": {n_pairs, n_dropped}}. use_kernels=False runs
    the plain torch versions of K1 and K2 on any device; otherwise every
    tensor must be on CUDA. pair_capacity is a floor (None: sized from the
    frame's exact pair count); no pair is ever dropped."""
    check_supported(config)
    check_devices(scene, cam0, use_kernels)
    starts, rows, dirs_t, origins_t, valid, n_pairs = prepare_rolling_stream(
        scene, cam0, cam1, config, pair_capacity, use_kernels)
    march_fn = march if use_kernels else march_plain
    rgb_t, t_final_t = march_fn(starts, rows, dirs_t, config, chunk_for(config),
                                origins_t=origins_t)
    out = frame_image(rgb_t, 1.0 - t_final_t, valid, cam0, config)
    if return_aux:
        out["aux"] = {"n_pairs": n_pairs, "n_dropped": 0}
    return out


def render_rolling_oracle(scene: GaussianScene, cam0: Camera, cam1: Camera,
                          config: RenderConfig = RenderConfig(), ray_chunk: int = 4096) -> dict:
    """Exact rolling-shutter frame (every ray against every gaussian):
    {rgb (H, W, 3) in [0, 1], alpha (H, W)}, on the scene's device."""
    origins, dirs, valid = generate_rays_rolling(cam0, cam1, config)
    rgb, density, _ = render_rays_oracle(scene, origins.reshape(-1, 3), dirs.reshape(-1, 3),
                                         config, ray_chunk=ray_chunk)
    return frame_from_rays(rgb, density, valid)
