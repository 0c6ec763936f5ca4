"""Full-frame primary render on the port's kernels (counterpart of
gaussian_ray_tracing_tpu/models/pallas_renderer.py, forward only).

Per frame: feature table with the quad columns -> exact conic footprints
and the central-ray event depth key -> the sorted pair stream
(ops/tiles.bin_pairs, whose head-fill scan is kernel K2) -> ONE gather of
compact per-pair rows -> the fused march (kernel K1) -> untile, clip and
blank. `use_kernels=False` runs the plain torch versions of both kernels
on any device; otherwise the kernels run and every tensor must be on CUDA.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import RenderConfig, check_supported
from gaussian_ray_tracing_tpu_torch.models.tiled import feature_table, tile_rays, untile_image
from gaussian_ray_tracing_tpu_torch.ops.march import chunk_for, compact_features, march, march_plain
from gaussian_ray_tracing_tpu_torch.ops.response import ray_ellipsoid_span
from gaussian_ray_tracing_tpu_torch.ops.tiles import bin_pairs, count_pairs, project_footprints_conic
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

_CAP_STEP = 65536


def snug_pair_capacity(n_pairs: int) -> int:
    """Pair capacity with ~20% slack: n_pairs * 1.2 rounded up to a
    multiple of 65,536 (the bench's drop-free sizing rule)."""
    return max(_CAP_STEP, -(-int(n_pairs * 1.2) // _CAP_STEP) * _CAP_STEP)


def prepare_pair_stream(scene: GaussianScene, camera: Camera, config: RenderConfig,
                        pair_capacity: int, use_kernels: bool = True):
    """Feature table -> footprints -> sorted pair stream -> per-pair rows.

    pair_capacity is a floor: if the frame emits more pairs, the stream is
    rebuilt at a snug capacity, so no pair is ever dropped.
    Returns (stream, pair_feats (n_pairs, 16) compact rows, n_pairs).
    """
    table, M, radius = feature_table(scene, config, eye=camera.eye)
    bound_radius = radius * torch.amax(scene.scales, dim=-1)
    fp = project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                  bound_radius, camera, config)
    # front-to-back key: the event t (entry, or exit from inside) along the
    # central ray through each gaussian
    rel = scene.means - camera.eye
    rho = torch.clamp(torch.sqrt(torch.sum(rel * rel, dim=-1)), min=1e-9)
    hit, t_in, t_out = ray_ellipsoid_span(scene.means, M, radius, camera.eye,
                                          rel / rho[:, None])
    key = torch.where(t_in >= config.t_min, t_in, t_out)
    fp = fp._replace(depth=torch.where(hit, key, rho))

    stream = bin_pairs(fp, camera, config, pair_capacity, use_kernel=use_kernels)
    n_pairs = int(stream.n_pairs)
    if n_pairs > pair_capacity:
        stream = bin_pairs(fp, camera, config, snug_pair_capacity(n_pairs),
                           use_kernel=use_kernels)
    if int(stream.n_dropped) != 0:
        raise RuntimeError(f"pair stream dropped {int(stream.n_dropped)} pairs")
    # gid is in depth-rank space; the valid slots are the first n_pairs
    rows = compact_features(table)[stream.order]
    return stream, rows[stream.gid[:n_pairs]], n_pairs


def render_gpu(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
               pair_capacity: int | None = None, return_aux: bool = False,
               use_kernels: bool = True):
    """Full-frame primary-ray render. Returns {rgb (H, W, 3) in [0, 1],
    alpha (H, W)} and, with return_aux, {"aux": {n_pairs, n_dropped}}."""
    check_supported(config)
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on {scene.device}")
    if use_kernels and scene.device.type != "cuda":
        raise RuntimeError(
            f"the CUDA kernels need CUDA tensors; the scene is on {scene.device}"
        )
    if pair_capacity is None:
        pair_capacity = snug_pair_capacity(int(count_pairs(scene, camera, config)))
    stream, pair_feats, n_pairs = prepare_pair_stream(
        scene, camera, config, pair_capacity, use_kernels=use_kernels
    )
    _, dirs, valid = generate_rays(camera, config)
    tw, th = config.tile_w, config.tile_h
    dirs_t = tile_rays(dirs, tw, th)
    march_fn = march if use_kernels else march_plain
    rgb_t, t_final_t = march_fn(stream.starts, pair_feats, dirs_t, config, chunk_for(config))

    H, W = camera.height, camera.width
    rgb = torch.clamp(untile_image(rgb_t, H, W, tw, th), 0.0, 1.0)
    alpha = untile_image((1.0 - t_final_t)[..., None], H, W, tw, th)[..., 0]
    out = {
        "rgb": torch.where(valid[..., None], rgb, 0.0),
        "alpha": torch.where(valid, alpha, 0.0),
    }
    if return_aux:
        out["aux"] = {"n_pairs": n_pairs, "n_dropped": 0}
    return out
