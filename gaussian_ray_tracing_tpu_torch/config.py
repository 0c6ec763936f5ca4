"""Render configuration (counterpart of gaussian_ray_tracing_tpu/config.py).

Same fields and defaults as the JAX `RenderConfig`, so a config built for
one package means the same render in the other. The field comments there
carry the history of each default; they are not repeated here.
`unsupported_fields` lists the values the ported render path does not
implement, so it can refuse them instead of rendering something else;
`unsupported_train_fields`, `unsupported_mesh_fields` and
`unsupported_tiled_fields` do the same for the training path, the mesh
tracer and the tiled march.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch


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
    # inversions (gaussian_ray_tracing_tpu/ops/pallas_march.py:781-796,
    # 858-893). With sort_alpha_min = 0 that reproduces the full sort's
    # significant order, so the port then sorts the whole chunk; with
    # sort_alpha_min > 0 the band's right end only sees the inversions the
    # fire test counts, and the port sorts the band as JAX does.
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


MAX_RAYS_PER_BLOCK = 1024  # one thread per ray: a CUDA block's limit


def tile_rays_supported(rays: int) -> bool:
    """Rays per tile the kernels take: a multiple of 32 up to 1024 (one
    CUDA block, one thread per ray), or any multiple of 128 above (K1 and
    K3 a thread-block cluster of up to 8 blocks of up to 1024 threads, each
    thread marching ceil(rays / 8192) rays in turn; K4 ceil(rays / 1024)
    blocks). A TPU takes any multiple of 128 (pallas_march.py:1036-1040),
    with no upper limit."""
    if rays <= MAX_RAYS_PER_BLOCK:
        return rays >= 32 and rays % 32 == 0
    return rays % 128 == 0


ORDERS = ("window", "key", "merge", "oddeven")
PAIR_KEYS = ("gaussian", "tile", "tile_peak", "affine")
# The chunks window and merge order march: JAX's bitonic sort and merge
# networks (ops/pallas_march.py:132-183) sort only a power of two, and the
# source index has 8 bits (:1106-1110). Key order and oddeven (stream order)
# take any chunk, block mode's chunk * bounce_blocks_per_chunk too; the
# tiled march's per-ray argsort takes any chunk in every order.
SORT_CHUNKS = (32, 64, 128, 256)


def chunk_for(config: RenderConfig) -> int:
    """March chunk of the primary render and of training: max(32,
    min(march_chunk, 256)), as JAX takes it (models/pallas_renderer.py:139,
    215; models/mesh_tracer.py:325, 653)."""
    return max(32, min(config.march_chunk, 256))


def sort_chunk_refusal(name: str, order: str, chunk: int, what: str) -> list[str]:
    """The refusal of window or merge order `order` (the field `name`) at a
    march chunk they do not sort (SORT_CHUNKS), naming the value (`what`,
    the chunk as the path computes it) and why."""
    if order not in ("window", "merge") or chunk in SORT_CHUNKS:
        return []
    return [f"{name}={order!r} at {what} (window and merge order take chunks of 32, 64, "
            f"128 or 256: JAX's bitonic network sorts only a power of two, "
            f"ops/pallas_march.py:132-183, and its 8-bit source index caps them at 256, "
            f":1106-1110; key and oddeven order take any chunk)"]


def _float_dtype(name) -> bool:
    dtype = getattr(torch, str(name), None)
    return isinstance(dtype, torch.dtype) and dtype.is_floating_point


def unsupported_fields(config: RenderConfig) -> list[str]:
    """Values of `config` the ported primary render does not implement:
    tiles of other than a multiple of 32 rays up to 1024 or a multiple of
    128 above (tile_rays_supported: the kernels' blocks and clusters, as a
    TPU takes a multiple of 128), SH degrees outside 0-3,
    hit multiplicities below 1, orders, order keys, pair keys and compute
    dtypes the JAX package does not have either, and window or merge order
    at a chunk_for other than 32, 64, 128 or 256 (SORT_CHUNKS: JAX runs
    them there, but its sort does not sort). compute_dtype is read by the
    tiled march alone (any float dtype); the kernel paths ignore it, as
    JAX's Pallas paths do."""
    chunk = chunk_for(config)
    rays = config.rays_per_tile
    bad = [] if tile_rays_supported(rays) else \
        [f"tile_w*tile_h={config.tile_w}*{config.tile_h} (rays per tile: a multiple of 32 up "
         f"to {MAX_RAYS_PER_BLOCK} or of 128 above)"]
    return bad + _unsupported_values(config) + sort_chunk_refusal(
        "order", config.order, chunk, f"march chunk {chunk}")


def _unsupported_values(config: RenderConfig) -> list[str]:
    """unsupported_fields but for the tile and the chunk: what the tiled
    march refuses."""
    checks = {
        "order": config.order in ORDERS,
        "window_key": config.window_key in ("event", "peak"),
        "pair_keys": config.pair_keys in PAIR_KEYS,
        "sh_degree": 0 <= config.sh_degree <= 3,
        "compute_dtype": _float_dtype(config.compute_dtype),
        "hit_multiplicity": config.hit_multiplicity >= 1,
    }
    return [f"{k}={getattr(config, k)!r}" for k, ok in checks.items() if not ok]


def unsupported_tiled_fields(config: RenderConfig) -> list[str]:
    """Values of `config` the ported tiled march (models/tiled.py) does not
    implement: the render's but for the tile and the chunk, since it pads
    any tile_w and tile_h, as JAX's tiled march does (models/tiled.py:42-59),
    and its per-ray argsort sorts any chunk in window order.
    It marches in config.compute_dtype (float64 for a witness, bfloat16 as
    JAX's does); merge order composites in stream order (key) and oddeven
    runs window_passes odd-even passes in place of the per-ray sort, as in
    the JAX tiled march."""
    return _unsupported_values(config)


def train_config(config: RenderConfig) -> RenderConfig:
    """The config the training path runs: every order other than window and
    key (merge among them) trains in key order, as JAX's render_pallas_diff
    maps it (pallas_renderer.py:208-209)."""
    return config if config.order in ("window", "key") else config.replace(order="key")


def unsupported_train_fields(config: RenderConfig) -> list[str]:
    """Values of `config` the ported training path does not implement yet:
    those of the render, after train_config's order mapping. It trains every
    camera model at SH degree 0-3 in window or key order (per-ray origins,
    which no config field selects, are refused by the march itself)."""
    return unsupported_fields(train_config(config))


def unsupported_mesh_fields(config: RenderConfig) -> list[str]:
    """Values of `config` the ported mesh tracer does not implement: on top
    of the render's limits (it traces every camera model at SH degree 0-3),
    bounced segments march in window, key, merge or oddeven order (stream
    order with the exact event gate, as K1 runs oddeven) in block mode's
    chunks of chunk_for * bounce_blocks_per_chunk rows (models/mesh_tracer.py
    :447-453): any number in key and oddeven order, 32, 64, 128 or 256 in
    window and merge order (JAX raises above 256)."""
    bad = unsupported_fields(config)
    if config.bounce_order not in ORDERS:
        bad.append(f"bounce_order={config.bounce_order!r}")
    bsub = max(1, config.bounce_blocks_per_chunk)
    block_chunk = chunk_for(config) * bsub
    return bad + sort_chunk_refusal(
        "bounce_order", config.bounce_order, block_chunk,
        f"block-mode chunk {block_chunk} (march chunk {chunk_for(config)} * "
        f"bounce_blocks_per_chunk {bsub})")


def _raise_unsupported(bad: list[str]) -> None:
    if bad:
        raise NotImplementedError(
            "not yet ported to gaussian_ray_tracing_tpu_torch: " + ", ".join(bad)
        )


def check_supported(config: RenderConfig) -> None:
    _raise_unsupported(unsupported_fields(config))


def check_tiled_supported(config: RenderConfig) -> None:
    _raise_unsupported(unsupported_tiled_fields(config))


def check_trainable(config: RenderConfig) -> None:
    _raise_unsupported(unsupported_train_fields(config))


def check_mesh_supported(config: RenderConfig) -> None:
    _raise_unsupported(unsupported_mesh_fields(config))
