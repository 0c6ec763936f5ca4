"""The binning's three pair culls on the port against the JAX package on
the CPU: `conic_cull` and `row_span` (pinhole, from the scene's geometry)
and `fisheye_cull` (the footprint's annular sector).

One scene, `random_scene(3000, seed=7)`, at 256x256 with the pinhole and
the fisheye camera. On JAX's footprints and geometry the port's `bin_pairs`
gives JAX's stream: the same starts, per-tile gaussian lists (gid, in
depth-rank order), n_pairs, and no drops. The port's own `projection_conics`
and `Footprint.sector` columns match JAX's at rtol 1e-5 on all but a
tail: 5% of the conic entries, each within 1e-4 of the normalized form
(|g| <= 1; measured on JAX's own geometry: 2.8% of g22 outside rtol 1e-5,
at most 4.7e-5, where s_w^2 - lam |aw|^2 cancels and XLA's CPU backend
contracts the sums into FMAs), and 10% of the visible gaussians' sector
entries, each within 1e-3 NDC (measured: up to 7.3% of r_lo outside rtol
1e-5, at most 5.3e-4 NDC off; the float32 Cardano eigen-solve of the
fisheye cone caps rounds differently under XLA, which moves rx and ry of
this scene's footprints by up to 1.1e-3 relative as well). The cull pads
its sector by 0.002 + 6 / width NDC, and its decisions absorb these
differences: the pair sets above are equal. A culled plain render
in key order equals the uncut one within JAX's atol 5e-4
(tests/test_conic_cull.py:131-154, tests/test_footprints.py:87-105: dropping
pairs of zero alpha regroups the prefix sums only), and the culled stream's
pairs are a subset of the uncut stream's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import CameraModel as JModel
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.tiled import feature_table as j_feature_table
from gaussian_ray_tracing_tpu.ops import tiles as jtiles
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import render_gpu
from gaussian_ray_tracing_tpu_torch.models.tiled import feature_table
from gaussian_ray_tracing_tpu_torch.ops import tiles as ttiles
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

torch.set_num_threads(1)
CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=256, height=256)
CAP = 400_000
CULLS = {"conic": dict(conic_cull=True), "row_span": dict(row_span=True),
         "both": dict(conic_cull=True, row_span=True), "fisheye": dict(fisheye_cull=True)}
T = lambda x: torch.from_numpy(np.array(x))


def _model(name: str) -> str:
    return "fisheye" if name == "fisheye" else "pinhole"


@functools.lru_cache(maxsize=None)
def _jax_inputs(model: str):
    """JAX's footprints (with the central-ray depth key, as its renderer
    bins them) and geometry (means, M9, radius) of the scene."""
    scene = j_random_scene(3000, seed=7)
    cfg = JConfig(hit_multiplicity=1, camera_model=JModel(model))
    cam = JCamera.create(**CAM)
    _, M, radius = j_feature_table(scene, cfg, eye=cam.eye)
    fp = jtiles.project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                         radius * jnp.max(scene.scales, axis=-1), cam, cfg)
    return scene, cam, fp, (scene.means, M.reshape(-1, 9), radius)


def _torch_footprint(jfp):
    sector = None if jfp.sector is None else tuple(T(v) for v in jfp.sector)
    return ttiles.Footprint(*(T(getattr(jfp, k)) for k in ttiles.Footprint._fields[:6]),
                            sector=sector)


def _tile_sets(stream) -> list:
    starts, gid = np.asarray(stream.starts), np.asarray(stream.gid)
    return [gid[a:b].tolist() for a, b in zip(starts[:-1], starts[1:])]


@pytest.mark.parametrize("name", list(CULLS))
def test_culled_bin_pairs_match_jax(name):
    """The port's bin_pairs on JAX's footprints and geometry: JAX's
    stream, and a subset of the uncut stream, with fewer pairs."""
    _, jcam, jfp, jgeom = _jax_inputs(_model(name))
    kw = dict(hit_multiplicity=1, camera_model=_model(name), **CULLS[name])
    want = jtiles.bin_pairs(jfp, jcam, JConfig(**{**kw, "camera_model": JModel(_model(name))}),
                            CAP, geom=jgeom)
    cfg = RenderConfig(**{**kw, "camera_model": CameraModel(_model(name))})
    cam, fp, geom = Camera.create(**CAM), _torch_footprint(jfp), tuple(T(g) for g in jgeom)
    got = ttiles.bin_pairs(fp, cam, cfg, CAP, geom=geom)
    assert int(got.n_dropped) == int(want.n_dropped) == 0
    assert int(got.n_pairs) == int(want.n_pairs)
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))
    assert np.array_equal(got.starts.numpy(), np.asarray(want.starts))
    got_sets = _tile_sets(got)
    assert got_sets == _tile_sets(want)
    uncut = ttiles.bin_pairs(fp, cam, RenderConfig(hit_multiplicity=1,
                                                   camera_model=cfg.camera_model), CAP)
    assert int(got.starts[-1]) < int(uncut.starts[-1])
    assert all(set(a) <= set(b) for a, b in zip(got_sets, _tile_sets(uncut)))


def test_projection_conics_and_sector_match_jax():
    """The port's projection_conics on its own geometry and the fisheye
    footprints' sector columns against JAX's."""
    jscene, jcam, _, jgeom = _jax_inputs("pinhole")
    scene = random_scene(3000, seed=7)
    cam = Camera.create(**CAM)
    _, M, radius = feature_table(scene, RenderConfig(hit_multiplicity=1), eye=cam.eye)
    got = ttiles.projection_conics((scene.means, M.reshape(-1, 9), radius), cam)
    want = jtiles.projection_conics(jgeom, jcam)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        live = ~np.isnan(b)  # the scene's padding rows
        assert np.array_equal(np.isnan(a), ~live)
        a, b = a[live], b[live]
        # rtol 1e-5 but on a tail of cancelling entries (module docstring)
        assert np.isclose(a, b, rtol=1e-5, atol=1e-6).mean() >= 0.95
        assert np.abs(a - b).max() <= 1e-4

    _, _, jfp, _ = _jax_inputs("fisheye")
    cfg = RenderConfig(hit_multiplicity=1, camera_model=CameraModel.FISHEYE)
    fp = ttiles.project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                         radius * torch.amax(scene.scales, dim=-1), cam, cfg)
    assert ttiles.project_footprints_conic(
        scene.means, scene.scales, scene.quats, radius,
        radius * torch.amax(scene.scales, dim=-1), cam, RenderConfig()).sector is None
    vis = fp.visible.numpy() & np.asarray(jfp.visible)
    assert vis.mean() > 0.9
    for k, (a, b) in enumerate(zip(fp.sector, jfp.sector)):
        a, b = a.numpy()[vis], np.asarray(b)[vis]
        # the Cardano eigen-solve's rounding (module docstring)
        assert np.isclose(a, b, rtol=1e-5, atol=1e-6).mean() >= 0.9, k
        assert np.abs(a - b).max() <= 1e-3, k


@pytest.mark.parametrize("name", ["both", "fisheye"])
def test_culled_render_equals_uncut_in_key_order(name):
    """The plain render (the port's binning, K2 and K1 plain) with the
    culls on equals the uncut one in key order within atol 5e-4, on fewer
    marched pairs."""
    cfg = RenderConfig(hit_multiplicity=1, order="key", chunk_skip_transmittance=1e-3,
                       max_per_tile=4096, camera_model=CameraModel(_model(name)))
    scene = random_scene(3000, seed=7)
    cam = Camera.create(**CAM)
    off = render_gpu(scene, cam, cfg, pair_capacity=CAP, use_kernels=False, return_aux=True)
    on = render_gpu(scene, cam, cfg.replace(**CULLS[name]), pair_capacity=CAP,
                    use_kernels=False, return_aux=True)
    np.testing.assert_allclose(on["rgb"].numpy(), off["rgb"].numpy(), atol=5e-4)
    assert float(off["alpha"].max()) > 0.5
    assert on["aux"]["n_pairs"] <= off["aux"]["n_pairs"]
