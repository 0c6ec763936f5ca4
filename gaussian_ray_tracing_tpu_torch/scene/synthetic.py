"""Seeded synthetic trained-like scenes (counterpart of
gaussian_ray_tracing_tpu/scene/synthetic.py).

The numpy RNG and its draw order are kept exactly, so both packages build
the same scene from the same seed.
"""

from __future__ import annotations

import numpy as np

from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene


def random_scene(
    n: int,
    seed: int = 0,
    extent: float = 1.0,
    mean_scale: float = 0.02,
    sh_degree: int = 3,
    layout: str = "shell",
    pad_to: int | None = None,
    density_scaling: bool = True,
    device="cpu",
) -> GaussianScene:
    """Seeded synthetic scene roughly matching trained-3DGS statistics.

    layout: "shell" puts 80% of the gaussians near a sphere surface plus a
    volumetric cloud; "uniform" fills the cube.
    """
    rng = np.random.default_rng(seed)
    if layout == "shell":
        n_shell = int(n * 0.8)
        d = rng.normal(size=(n_shell, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
        r = extent * (0.85 + 0.1 * rng.normal(size=(n_shell, 1)))
        shell = d * r
        cloud = rng.uniform(-extent, extent, size=(n - n_shell, 3))
        means = np.concatenate([shell, cloud], 0).astype(np.float32)
    elif layout == "uniform":
        means = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    else:
        raise ValueError(layout)

    density_factor = (100_000 / max(n, 1)) ** (1 / 3) if density_scaling else 1.0
    log_s = np.log(mean_scale * density_factor) + 0.6 * rng.normal(size=(n, 3))
    raw_scales = log_s.astype(np.float32)
    raw_quats = rng.normal(size=(n, 4)).astype(np.float32)
    raw_op = rng.normal(loc=1.0, scale=2.0, size=(n,)).astype(np.float32)

    k = (sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, :] = rng.normal(loc=0.0, scale=1.2, size=(n, 3))
    if k > 1:
        sh[:, 1:, :] = 0.08 * rng.normal(size=(n, k - 1, 3))
    return GaussianScene.from_raw(means, raw_scales, raw_quats, raw_op, sh,
                                  pad_to=pad_to, device=device)
