"""The port's RenderConfig against the JAX package's, and the values the
ported render path refuses."""

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
    dict(camera_model=tcfg.CameraModel.FISHEYE),
    dict(camera_model=tcfg.CameraModel.OPENCV, distortion=(0.1, 0.0, 0.0, 0.0)),
    dict(order="key"),
    dict(order="merge"),
    dict(sh_degree=1),
    dict(conic_cull=True),
    dict(row_span=True),
    dict(fisheye_cull=True),
    dict(sort_lane_groups=True),
    dict(composite_scan=True),
    dict(sort_alpha_min=0.05),
    dict(window_key="peak"),
    dict(pair_keys="tile"),
])
def test_unimplemented_values_raise(change):
    with pytest.raises(NotImplementedError):
        tcfg.check_supported(tcfg.RenderConfig(**change))


def test_defaults_and_bench_config_are_supported():
    tcfg.check_supported(tcfg.RenderConfig())
    tcfg.check_supported(tcfg.RenderConfig(hit_multiplicity=1, march_chunk=128))
    # accepted with no effect on the output
    tcfg.check_supported(tcfg.RenderConfig(packed16=False, sort_repair=0))
