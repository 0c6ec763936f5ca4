"""Render configuration (counterpart of gaussian_ray_tracing_tpu/config.py).

Same fields and defaults as the JAX `RenderConfig`, so a config built for
one package means the same render in the other. The field comments there
carry the history of each default; they are not repeated here.
`unsupported_fields` lists the values the ported render path does not
implement yet, so it can refuse them instead of rendering something else.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class CameraModel(enum.Enum):
    PINHOLE = "pinhole"
    FISHEYE = "fisheye"
    OPENCV = "opencv"


class MeshType(enum.IntEnum):
    """Secondary-ray interaction type for inserted triangle meshes."""

    MIRROR = 0
    NORMAL = 1
    GLASS = 2


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) renderer configuration; defaults = the reference."""

    # --- Gaussian pass ---
    t_min: float = 1e-3
    t_max: float = 1e5
    min_transmittance: float = 1e-3
    alpha_min: float = 0.01
    alpha_clamp: float = 0.99
    sh_degree: int = 0

    # --- Mesh (secondary-bounce) pass ---
    mesh_t_min: float = 1e-5
    mesh_t_max: float = 1e5
    max_bounces: int = 32
    refraction_eps_shift: float = 1e-5
    glass_ior: float = 1.5
    air_ior: float = 1.0003
    mesh_type: MeshType = MeshType.MIRROR

    # --- Hit multiplicity: 2 = the reference's double anyhit per hull ---
    hit_multiplicity: int = 2

    # --- Camera ---
    camera_model: CameraModel = CameraModel.PINHOLE
    fisheye_focal: float = 1.0 / math.sqrt(2.0)
    distortion: tuple = ()

    # --- Tiled-renderer knobs ---
    tile_w: int = 16
    tile_h: int = 16
    max_per_tile: int = 1024
    march_chunk: int = 256
    order: str = "window"
    window_passes: int = 16
    window_key: str = "event"
    pair_keys: str = "gaussian"
    exact_bbox: bool = True
    conic_cull: bool = False
    fisheye_cull: bool = False
    row_span: bool = False
    # packed16 is a bit-exact TPU byte layout of the pair features (int16
    # hi/lo halves of each f32, gaussian_ray_tracing_tpu/models/tiled.py
    # feature_table_packed16): it never changes a rendered value, so the
    # port accepts it and always moves plain f32 rows.
    packed16: bool = True
    sh_mxu: bool = True
    bounce_order: str = "window"
    bounce_block_budget: int = 16
    bounce_blocks_per_chunk: int = 1
    sort_lane_groups: bool = False
    composite_scan: bool = False
    # sort_repair sorts only the index band of a fired chunk that holds its
    # inversions; that reproduces the full sort's significant order
    # (gaussian_ray_tracing_tpu/ops/pallas_march.py:781-796), so the port
    # accepts it and always sorts the whole chunk.
    sort_repair: int = 64
    sort_alpha_min: float = 0.0
    chunk_skip_transmittance: float = 0.02
    compute_dtype: str = "float32"
    use_pallas: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def rays_per_tile(self) -> int:
        return self.tile_w * self.tile_h


DEFAULT_CONFIG = RenderConfig()


def unsupported_fields(config: RenderConfig) -> list[str]:
    """Values of `config` the ported primary render does not implement yet
    (pinhole, window order on the event key, quad response, SH degree 0)."""
    bad = []
    if config.camera_model != CameraModel.PINHOLE or config.distortion:
        bad.append(f"camera_model={config.camera_model.value}")
    checks = {
        "order": config.order == "window",
        "window_key": config.window_key == "event",
        "pair_keys": config.pair_keys == "gaussian",
        "sh_degree": config.sh_degree == 0,
        "conic_cull": not config.conic_cull,
        "row_span": not config.row_span,
        "fisheye_cull": not config.fisheye_cull,
        "sort_lane_groups": not config.sort_lane_groups,
        "composite_scan": not config.composite_scan,
        "sort_alpha_min": config.sort_alpha_min <= 0.0,
        "compute_dtype": config.compute_dtype == "float32",
        "hit_multiplicity": config.hit_multiplicity >= 1,
    }
    bad += [f"{k}={getattr(config, k)!r}" for k, ok in checks.items() if not ok]
    return bad


def check_supported(config: RenderConfig) -> None:
    bad = unsupported_fields(config)
    if bad:
        raise NotImplementedError(
            "not yet ported to gaussian_ray_tracing_tpu_torch: " + ", ".join(bad)
        )
