"""Per-gaussian feature table and tile layout helpers (the main-path parts
of gaussian_ray_tracing_tpu/models/tiled.py).

The XLA tiled march itself is not ported: the port's plain march
(ops/march.py march_plain) is the pure-array twin of the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops.response import (
    adaptive_radius,
    canonical_frames,
    dot3,
    mat3_apply,
)
from gaussian_ray_tracing_tpu_torch.ops.sh import SH_C0, num_coeffs
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

# fixed column indices of the quadratic-form block (see feature_table)
QUAD_Q0 = 64  # q00,q11,q22,q01,q02,q12 at 64..69 (+2 pad)
QUAD_V0 = 72  # vx,vy,vz at 72..74
QUAD_CQ = 75
QUAD_OO = 76
QUAD_RGB = 77  # cr,cg,cb at 77..79 (sh_degree 0)


def tile_rays(dirs: torch.Tensor, tile_w: int, tile_h: int) -> torch.Tensor:
    """(H, W, C) -> (T, tile_h*tile_w, C), zero-padding H/W up to tile
    multiples (padded rays have zero direction and are never live)."""
    H, W = dirs.shape[:2]
    Hp, Wp = -(-H // tile_h) * tile_h, -(-W // tile_w) * tile_w
    if (Hp, Wp) != (H, W):
        dirs = F.pad(dirs, (0, 0, 0, Wp - W, 0, Hp - H))
    ty, tx = Hp // tile_h, Wp // tile_w
    x = dirs.reshape(ty, tile_h, tx, tile_w, -1).permute(0, 2, 1, 3, 4)
    return x.reshape(ty * tx, tile_h * tile_w, -1).contiguous()


def untile_image(tiles: torch.Tensor, height: int, width: int, tile_w: int,
                 tile_h: int) -> torch.Tensor:
    """(T, tile_h*tile_w, C) -> (H, W, C), cropping tile padding."""
    ty, tx = -(-height // tile_h), -(-width // tile_w)
    c = tiles.shape[-1]
    x = tiles.reshape(ty, tx, tile_h, tile_w, c).permute(0, 2, 1, 3, 4)
    return x.reshape(ty * tile_h, tx * tile_w, c)[:height, :width]


def feature_table(scene: GaussianScene, config: RenderConfig, eye=None):
    """Per-gaussian feature table (N, 14+3K), or (N, 80) with `eye`.

    Columns: [mx, my, mz, m00..m22 (rows of M = S^-1 R^T), opacity, iso
    radius, sh_r[0..K-1], sh_g[...], sh_b[...]]. With `eye` (the shared
    primary-ray origin) the quadratic-form block follows at the JAX
    package's fixed indices, with Q = M^T M and rel = eye - mu:

      64..69: q00, q11, q22, q01, q02, q12
      72..74: v = Q rel
      75:     cq = rel^T Q rel - radius^2
      76:     oo = rel^T Q rel
      77..79: max(0.5 + C0*sh0, 0) per channel (sh_degree 0 only)

    Returns (table, M (N, 3, 3), radius (N,)).
    """
    M = canonical_frames(scene.scales, scene.quats)
    radius = adaptive_radius(scene.opacities, config.alpha_min)
    k = num_coeffs(config.sh_degree)
    cols = [
        scene.means,
        M.reshape(-1, 9),
        scene.opacities[:, None],
        radius[:, None],
        scene.sh[:, :k, 0],
        scene.sh[:, :k, 1],
        scene.sh[:, :k, 2],
    ]
    table = torch.cat(cols, dim=1)
    if eye is None:
        return table, M, radius
    n, nf = table.shape
    if nf > QUAD_Q0:
        raise ValueError(f"feature table width {nf} collides with quad columns at {QUAD_Q0}")
    # Q[i, j] = sum_k M[k, i] M[k, j], v = Q rel
    Q = dot3([M[:, k, :, None] for k in range(3)], [M[:, k, None, :] for k in range(3)])
    rel = eye.to(torch.float32)[None, :] - scene.means
    v = mat3_apply(Q, rel)
    oo = torch.sum(rel * v, dim=-1)
    cq = oo - radius * radius
    z = torch.zeros((n, 1), dtype=torch.float32, device=table.device)
    quad = [
        Q[:, 0, 0, None], Q[:, 1, 1, None], Q[:, 2, 2, None],
        Q[:, 0, 1, None], Q[:, 0, 2, None], Q[:, 1, 2, None],
        z, z,  # 70, 71
        v,  # 72..74
        cq[:, None], oo[:, None],  # 75, 76
    ]
    if config.sh_degree == 0:
        quad.append(torch.clamp(0.5 + SH_C0 * scene.sh[:, 0, :], min=0.0))
    pad = torch.zeros((n, QUAD_Q0 - nf), dtype=torch.float32, device=table.device)
    return torch.cat([table, pad, *quad], dim=1), M, radius


def default_pair_capacity(n: int) -> int:
    return max(8 * n, 1 << 16)
