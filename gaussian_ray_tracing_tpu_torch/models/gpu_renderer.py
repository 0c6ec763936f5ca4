"""Full-frame primary render on the port's kernels (counterpart of
gaussian_ray_tracing_tpu/models/pallas_renderer.py).

Per frame: feature table with the quad columns -> exact footprints (the
projected conic's bbox; fisheye: the hit-cone caps' polar rectangle;
OpenCV: through the forward distortion) and the central-ray event depth
key -> the sorted pair stream (ops/tiles.bin_pairs, whose head-fill scan
is kernel K2) -> ONE gather of per-pair rows -> the fused march (kernel
K1) -> untile, clip and blank (fisheye pixels outside r <= 1).
`render_gpu` is the forward render (pinhole, fisheye or OpenCV; window or
key order; SH degree 0 to 3 on the quad rows of ops/march.compact_features);
`render_gpu_diff` is the differentiable render on any of those cameras
(window order on the scalar response, key order on the quad response, SH
degree 0 to 3), whose backward is kernel K3 (ops/march_bwd.py).
`use_kernels=False` runs the
plain torch versions of the kernels on any device; otherwise the kernels
run and every tensor must be on CUDA.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import (
    RenderConfig, check_supported, check_trainable, chunk_for, train_config,
)
from gaussian_ray_tracing_tpu_torch.models.tiled import (
    depth_key, feature_table, tile_rays, untile_image,
)
from gaussian_ray_tracing_tpu_torch.ops.march import (
    compact_features, march, march_plain, scalar_features, train_features,
)
from gaussian_ray_tracing_tpu_torch.ops.march_bwd import march_stream_diff
from gaussian_ray_tracing_tpu_torch.ops.tiles import bin_pairs, count_pairs, project_footprints_conic
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

_CAP_STEP = 65536


def snug_pair_capacity(n_pairs: int) -> int:
    """Pair capacity with ~20% slack: n_pairs * 1.2 rounded up to a
    multiple of 65,536 (the bench's drop-free sizing rule)."""
    return max(_CAP_STEP, -(-int(n_pairs * 1.2) // _CAP_STEP) * _CAP_STEP)


def bin_footprints(fp, camera: Camera, config: RenderConfig, pair_capacity: int,
                   use_kernels: bool = True, tile_rows=None, geom=None):
    """Footprints (depth = the sort key) -> sorted pair stream (of the band
    of tile rows `tile_rows`, ops/tiles.bin_pairs, if given; geom = (means,
    M9, radius) for the pinhole culls and the per-pair keys).

    pair_capacity is a floor: if the frame emits more pairs, the stream is
    rebuilt at a snug capacity, so no pair is ever dropped.
    Returns (stream, per-pair gaussian ids of the kept pairs, n_pairs
    emitted: a conic or sector cull keeps fewer, starts[-1]).
    """
    stream = bin_pairs(fp, camera, config, pair_capacity, use_kernel=use_kernels,
                       tile_rows=tile_rows, geom=geom)
    n_pairs = int(stream.n_pairs)
    if n_pairs > pair_capacity:
        stream = bin_pairs(fp, camera, config, snug_pair_capacity(n_pairs),
                           use_kernel=use_kernels, tile_rows=tile_rows, geom=geom)
    if int(stream.n_dropped) != 0:
        raise RuntimeError(f"pair stream dropped {int(stream.n_dropped)} pairs")
    # the kept slots are the first starts[-1]; gid is in depth-rank space,
    # or holds gaussian ids under a per-pair key (order None)
    kept = int(stream.starts[-1]) if config.conic_cull or config.fisheye_cull else n_pairs
    gid = stream.gid[:kept].long()
    return stream, gid if stream.order is None else stream.order[gid], n_pairs


def bin_frame(scene: GaussianScene, M, radius, camera: Camera, config: RenderConfig,
              pair_capacity: int, use_kernels: bool = True):
    """Footprints and the central-ray depth key -> sorted pair stream
    (bin_footprints, with the scene's geometry for the pinhole culls and
    config.pair_keys, as JAX's pallas_renderer.py:75-76 bins). Returns
    (stream, per-pair gaussian ids, n_pairs)."""
    bound_radius = radius * torch.amax(scene.scales, dim=-1)
    fp = project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                  bound_radius, camera, config)
    fp = fp._replace(depth=depth_key(scene, M, radius, camera.eye, config))
    return bin_footprints(fp, camera, config, pair_capacity, use_kernels,
                          geom=(scene.means, M.reshape(-1, 9), radius))


def prepare_pair_stream(scene: GaussianScene, camera: Camera, config: RenderConfig,
                        pair_capacity: int, use_kernels: bool = True, with_table: bool = False,
                        quad: bool = True):
    """Feature table -> footprints -> sorted pair stream -> per-pair rows.
    Returns (stream, pair_feats (n_pairs, quad_row) rows, n_pairs) (quad
    False: (n_pairs, scalar_row) rows, ops/march.scalar_features) and,
    with_table (the mesh tracer's bounced rays), also the whole table as
    (N, train_row) training rows at the config's SH degree, in gaussian
    order (K1 block mode reads their scalar columns), and the per-gaussian
    bound radius (N,) (radius * max scale) for the Morton block index."""
    table, M, radius = feature_table(scene, config, eye=camera.eye)
    stream, ids, n_pairs = bin_frame(scene, M, radius, camera, config, pair_capacity,
                                     use_kernels)
    rows = compact_features if quad else scalar_features
    out = (stream, rows(table, config.sh_degree)[ids], n_pairs)
    if with_table:
        out += (train_features(table, config.sh_degree),
                radius * torch.amax(scene.scales, dim=-1))
    return out


def prepare_train_stream(scene: GaussianScene, camera: Camera, config: RenderConfig,
                         pair_capacity: int | None = None, use_kernels: bool = True):
    """The training counterpart of prepare_pair_stream: the feature table
    with autograd, binning on detached tensors (it carries no gradient, as
    in the reference), then one gather of (n_pairs, train_row) training
    rows (ops/march.train_features: 32 floats at SH 0, 80 at SH 3).
    Returns (stream, rows, n_pairs)."""
    table, M, radius = feature_table(scene, config, eye=camera.eye)
    fixed = GaussianScene(*(getattr(scene, k).detach()
                            for k in ("means", "scales", "quats", "opacities", "sh")),
                          num_active=scene.num_active)
    if pair_capacity is None:
        pair_capacity = snug_pair_capacity(int(count_pairs(fixed, camera, config)))
    stream, ids, n_pairs = bin_frame(fixed, M.detach(), radius.detach(), camera, config,
                                     pair_capacity, use_kernels)
    return stream, train_features(table, config.sh_degree)[ids], n_pairs


def check_devices(scene: GaussianScene, camera: Camera, use_kernels: bool):
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on {scene.device}")
    if use_kernels and scene.device.type != "cuda":
        raise RuntimeError(
            f"the CUDA kernels need CUDA tensors; the scene is on {scene.device}"
        )


def frame_image(rgb_t, alpha_t, valid, camera: Camera, config: RenderConfig) -> dict:
    """Untile, clip rgb to [0, 1] and blank invalid pixels."""
    H, W = camera.height, camera.width
    tw, th = config.tile_w, config.tile_h
    rgb = torch.clamp(untile_image(rgb_t, H, W, tw, th), 0.0, 1.0)
    alpha = untile_image(alpha_t[..., None], H, W, tw, th)[..., 0]
    return {
        "rgb": torch.where(valid[..., None], rgb, 0.0),
        "alpha": torch.where(valid, alpha, 0.0),
    }


def render_gpu(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
               pair_capacity: int | None = None, return_aux: bool = False,
               use_kernels: bool = True, quad: bool = True):
    """Full-frame primary-ray render. Returns {rgb (H, W, 3) in [0, 1],
    alpha (H, W)} and, with return_aux, {"aux": {n_pairs, n_dropped}}.
    quad=False (JAX render_pallas(quad=False)) marches the scalar response
    in the canonical frame from per-ray origins, each the eye (K1's
    per-ray-origin mode on the scalar rows), as the tiled march computes
    it; quad=True the quadratic form from the shared eye."""
    check_supported(config)
    check_devices(scene, camera, use_kernels)
    if pair_capacity is None:
        pair_capacity = snug_pair_capacity(int(count_pairs(scene, camera, config)))
    stream, pair_feats, n_pairs = prepare_pair_stream(
        scene, camera, config, pair_capacity, use_kernels=use_kernels, quad=quad
    )
    _, dirs, valid = generate_rays(camera, config)
    dirs_t = tile_rays(dirs, config.tile_w, config.tile_h)
    march_fn = march if use_kernels else march_plain
    origins = None if quad else camera.eye.to(torch.float32).expand(dirs_t.shape).contiguous()
    rgb_t, t_final_t = march_fn(stream.starts, pair_feats, dirs_t, config, chunk_for(config),
                                origins_t=origins)
    out = frame_image(rgb_t, 1.0 - t_final_t, valid, camera, config)
    if return_aux:
        out["aux"] = {"n_pairs": n_pairs, "n_dropped": 0}
    return out


def render_gpu_diff(scene: GaussianScene, camera: Camera, config: RenderConfig = RenderConfig(),
                    pair_capacity: int | None = None, use_kernels: bool = True):
    """Differentiable full-frame render (counterpart of render_pallas_diff):
    the forward is K1 with saved carries, the backward K3. Orders other
    than window and key train in key order, as in the reference
    (config.train_config). Per-pair row gradients flow through the row
    gather (a scatter-add) into the feature table and from there to the
    scene's means, M (scales and rotations), opacities and SH coefficients.
    Binning carries no gradient: the footprints (any camera model), depth
    key and pair stream are computed on detached tensors.
    Returns {rgb (H, W, 3), alpha (H, W)}."""
    config = train_config(config)
    check_trainable(config)
    check_devices(scene, camera, use_kernels)
    stream, rows, _ = prepare_train_stream(scene, camera, config, pair_capacity, use_kernels)
    _, dirs, valid = generate_rays(camera, config)
    dirs_t = tile_rays(dirs, config.tile_w, config.tile_h)
    rgb_t, t_final_t = march_stream_diff(rows, stream.starts, dirs_t,
                                         camera.eye.to(torch.float32), config,
                                         chunk_for(config), use_kernels)
    return frame_image(rgb_t, 1.0 - t_final_t, valid, camera, config)
