"""The port's RenderConfig against the JAX package's, and the values the
ported render and training paths refuse."""

import dataclasses

import pytest
import torch

from gaussian_ray_tracing_tpu import config as jcfg
from gaussian_ray_tracing_tpu_torch import config as tcfg

torch.set_num_threads(1)


def _plain(v):
    return v.value if hasattr(v, "value") else v


def test_defaults_match_jax_field_by_field():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.RenderConfig)}
    assert list(tf) == list(jf)
    for name, default in jf.items():
        assert _plain(tf[name]) == _plain(default), name
    assert tcfg.RenderConfig().rays_per_tile == jcfg.RenderConfig().rays_per_tile


def test_enums_match_jax():
    assert [(m.name, m.value) for m in tcfg.CameraModel] == \
        [(m.name, m.value) for m in jcfg.CameraModel]
    assert [(m.name, int(m)) for m in tcfg.MeshType] == \
        [(m.name, int(m)) for m in jcfg.MeshType]


def test_config_is_frozen_and_hashable():
    c = tcfg.RenderConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.t_min = 1.0
    assert hash(c) == hash(tcfg.RenderConfig())
    assert c.replace(march_chunk=128).march_chunk == 128


@pytest.mark.parametrize("change", [
    dict(sh_degree=4),
    dict(tile_w=12, tile_h=12),  # 144 rays: not a multiple of 32
    dict(tile_w=4, tile_h=4),
    dict(tile_w=32, tile_h=33),  # 1056 rays: above 1024, not a multiple of 128
    dict(window_key="oracle"),
    dict(order="sorted"),
])
def test_unimplemented_values_raise(change):
    with pytest.raises(NotImplementedError):
        tcfg.check_supported(tcfg.RenderConfig(**change))


@pytest.mark.parametrize("change", [
    dict(order="oddeven"),
    dict(compute_dtype="bfloat16"),
    dict(pair_keys="affine"),
    dict(pair_keys="tile_peak"),
    dict(compute_dtype="float16"),
    dict(pair_keys="tile"),
    dict(tile_w=130, tile_h=64),  # 8320 rays a tile: two rays a thread of a cluster's 8192
])
def test_ported_values_run(change):
    """The values JAX has that the port once refused: every check passes,
    and a tiny frame renders finite on the plain kernel path, the tiled
    march and the training render (tests/test_torch_pair_keys.py and
    tests/test_torch_oddeven.py hold them against JAX)."""
    from gaussian_ray_tracing_tpu_torch.cameras import Camera
    from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    cfg = tcfg.RenderConfig(hit_multiplicity=1, **change)
    tcfg.check_supported(cfg)
    tcfg.check_trainable(cfg)
    tcfg.check_tiled_supported(cfg)
    tcfg.check_mesh_supported(cfg.replace(bounce_order=cfg.order))
    scene = random_scene(200, seed=2)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=32, height=32)
    for out in (render(scene, cam, cfg, method="plain"), render(scene, cam, cfg, method="tiled"),
                render_diff(scene, cam, cfg, method="plain")):
        assert out["rgb"].shape == (32, 32, 3) and bool(torch.isfinite(out["rgb"]).all())
        assert float(out["alpha"].max()) > 0.5


@pytest.mark.parametrize("change", [
    dict(order="merge", window_key="peak"),
    dict(sort_lane_groups=True),
    dict(composite_scan=True),
    dict(sort_alpha_min=0.05),
    dict(window_key="peak"),
])
def test_window_order_options_are_supported(change):
    """K1's window-order render options and the peak key: the render, the
    mesh tracer and the tiled march take them, and training too (the
    render-only options are ignored there, as in JAX; merge trains as key)."""
    cfg = tcfg.RenderConfig(**change)
    tcfg.check_supported(cfg)
    tcfg.check_trainable(cfg)
    tcfg.check_mesh_supported(cfg.replace(bounce_order=cfg.order))
    tcfg.check_tiled_supported(cfg)


def test_defaults_and_bench_config_are_supported():
    tcfg.check_supported(tcfg.RenderConfig())
    for culls in (dict(conic_cull=True, row_span=True),
                  dict(camera_model=tcfg.CameraModel.FISHEYE, fisheye_cull=True)):
        tcfg.check_supported(tcfg.RenderConfig(**culls))
    for tile_w, tile_h in ((32, 16), (32, 32), (8, 4)):
        tcfg.check_trainable(tcfg.RenderConfig(tile_w=tile_w, tile_h=tile_h))
    tcfg.check_supported(tcfg.RenderConfig(hit_multiplicity=1, march_chunk=128))
    tcfg.check_supported(tcfg.RenderConfig(order="key"))
    tcfg.check_supported(tcfg.RenderConfig(order="merge", march_chunk=64))
    tcfg.check_mesh_supported(tcfg.RenderConfig(order="merge", bounce_order="merge"))
    tcfg.check_supported(tcfg.RenderConfig(camera_model=tcfg.CameraModel.FISHEYE, sh_degree=3))
    tcfg.check_supported(tcfg.RenderConfig(camera_model=tcfg.CameraModel.OPENCV,
                                           distortion=(0.1, 0.0, 0.0, 0.0), sh_degree=1))


@pytest.mark.parametrize("change", [
    dict(camera_model=tcfg.CameraModel.FISHEYE),
    dict(camera_model=tcfg.CameraModel.OPENCV, distortion=(-0.2, 0.0, 0.0, 0.0)),
    dict(sh_degree=1), dict(sh_degree=3),
])
def test_training_and_mesh_take_cameras_and_sh(change):
    """The render, training (K1 with saved carries, K3) and the mesh tracer
    take fisheye, OpenCV and SH 1-3 (training in both orders); the mesh
    tracer takes oddeven with them on bounce 0 and the bounced segments, as
    JAX's does (stream order, tests/test_torch_oddeven.py), and still
    refuses an order JAX does not have."""
    tcfg.check_supported(tcfg.RenderConfig(**change))
    for order in ("key", "window"):
        tcfg.check_trainable(tcfg.RenderConfig(order=order, **change))
    tcfg.check_mesh_supported(tcfg.RenderConfig(**change))
    for ported in (dict(order="oddeven"), dict(bounce_order="oddeven")):
        tcfg.check_mesh_supported(tcfg.RenderConfig(**change, **ported))
    with pytest.raises(NotImplementedError):
        tcfg.check_mesh_supported(tcfg.RenderConfig(**change, bounce_order="sorted"))


@pytest.mark.parametrize("change,trains", [
    (dict(order="window"), True), (dict(order="merge"), True), (dict(sh_degree=2), True),
    (dict(hit_multiplicity=0), False), (dict(camera_model=tcfg.CameraModel.FISHEYE), True),
])
def test_training_config_check(change, trains):
    """Training runs window and key order (any other order as key, as JAX's
    render_pallas_diff maps it), SH 0-3, every camera model and hit
    multiplicity >= 1."""
    tcfg.check_trainable(tcfg.RenderConfig(order="key", hit_multiplicity=1))
    tcfg.check_trainable(tcfg.RenderConfig(order="key", hit_multiplicity=3))
    cfg = tcfg.RenderConfig(**{"order": "key", **change})
    if trains:
        tcfg.check_trainable(cfg)
        assert tcfg.train_config(cfg).order == ("window" if cfg.order == "window" else "key")
    else:
        with pytest.raises(NotImplementedError):
            tcfg.check_trainable(cfg)
    # accepted with no effect on the output
    tcfg.check_supported(tcfg.RenderConfig(packed16=False, sort_repair=0))
