"""Elementwise parts of the port against the JAX package on the same
numpy-seeded inputs.

Tolerance rtol 1e-5, atol 1e-6 (float32): the two frameworks may associate
or contract (FMA) the same float32 expression differently, a few ulp."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussian_ray_tracing_tpu import cameras as jcam
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import tiled as jtiled
from gaussian_ray_tracing_tpu.ops import quaternion as jq
from gaussian_ray_tracing_tpu.ops import response as jresp
from gaussian_ray_tracing_tpu.ops import sh as jsh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu.utils import image as jimage
from gaussian_ray_tracing_tpu_torch import cameras as tcam
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.ops import quaternion as tq
from gaussian_ray_tracing_tpu_torch.ops import response as tresp
from gaussian_ray_tracing_tpu_torch.ops import sh as tsh
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils import image as timage

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("means", "scales", "quats", "opacities", "sh")


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), **(tol or TOL))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def scenes():
    js = j_random_scene(700, seed=4)
    arrays = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    return js, GaussianScene.from_numpy(arrays, js.num_active)


def test_quaternion():
    q = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    _close(jq.normalize_quat(q), tq.normalize_quat(_t(q)))
    qn = np.asarray(jq.normalize_quat(q))
    _close(jq.quat_to_rotmat(qn), tq.quat_to_rotmat(_t(qn)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(jsh.eval_sh(sh, d, degree), tsh.eval_sh(_t(sh), _t(d), degree))
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    _close(jsh.sh_basis(x, y, z, degree), tsh.sh_basis(_t(x), _t(y), _t(z), degree))
    assert tsh.num_coeffs(degree) == jsh.num_coeffs(degree)


def test_response(scenes):
    js, ts = scenes
    M_j = jresp.canonical_frames(js.scales, js.quats)
    M_t = tresp.canonical_frames(ts.scales, ts.quats)
    _close(M_j, M_t)
    r_j = jresp.adaptive_radius(js.opacities, 0.01)
    r_t = tresp.adaptive_radius(ts.opacities, 0.01)
    _close(r_j, r_t)
    assert float(r_t[ts.num_active:].abs().max()) == 0.0  # opacity 0 -> radius 0
    o = np.array([0.1, 0.3, 2.5], np.float32)
    rel = np.asarray(js.means) - o
    dirs = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    n = js.num_active  # padding gaussians have zero radius; compare active ones
    resp_j, ts_j = jresp.max_response(js.means[:n], M_j[:n], o, -dirs[:n])
    resp_t, ts_t = tresp.max_response(ts.means[:n], M_t[:n], _t(o), _t(-dirs[:n]))
    _close(resp_j, resp_t)
    _close(ts_j, ts_t)
    hit_j, in_j, out_j = jresp.ray_ellipsoid_span(js.means, M_j, r_j, o, -dirs)
    hit_t, in_t, out_t = tresp.ray_ellipsoid_span(ts.means, M_t, r_t, _t(o), _t(-dirs))
    assert np.array_equal(np.asarray(hit_j), hit_t.numpy())
    h = np.asarray(hit_j)
    _close(np.asarray(in_j)[h], in_t.numpy()[h])
    _close(np.asarray(out_j)[h], out_t.numpy()[h])


def test_generate_rays_pinhole():
    kw = dict(eye=(0.3, 0.4, 2.7), lookat=(0.0, 0.1, 0.0), fov_y_deg=50.0,
              width=40, height=24)
    jc, tc = jcam.Camera.create(**kw), tcam.Camera.create(**kw)
    for a, b in zip(jc.uvw_frame(), tc.uvw_frame()):
        _close(a, b)
    assert np.array_equal(np.asarray(jcam.pixel_ndc(40, 24)), tcam.pixel_ndc(40, 24).numpy())
    jo, jd, jv = jcam.generate_rays(jc, JConfig())
    to, td, tv = tcam.generate_rays(tc, RenderConfig())
    _close(jo, to)
    _close(jd, td)
    assert bool(tv.all()) and np.asarray(jv).all()
    jorb = jcam.orbit_camera((0.1, 0.0, 0.0), 2.5, 30.0, 15.0, width=8, height=8)
    torb = tcam.orbit_camera((0.1, 0.0, 0.0), 2.5, 30.0, 15.0, width=8, height=8)
    _close(jorb.eye, torb.eye)


def test_feature_table_quad_columns(scenes):
    js, ts = scenes
    eye = np.array([0.0, 0.3, 2.8], np.float32)
    tj, Mj, rj = jtiled.feature_table(js, JConfig(), eye=jnp.asarray(eye))
    tt, Mt, rt = ttiled.feature_table(ts, RenderConfig(), eye=_t(eye))
    assert tt.shape == tj.shape == (ts.num_gaussians, 80)
    _close(tj, tt)
    _close(Mj, Mt)
    _close(rj, rt)


def test_tile_rays_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(37, 45, 3)).astype(np.float32)  # partial tiles
    jt = jtiled.tile_rays(jnp.asarray(x), 16, 16)
    tt = ttiled.tile_rays(_t(x), 16, 16)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    back = ttiled.untile_image(tt, 37, 45, 16, 16)
    assert np.array_equal(back.numpy(), x)
    assert ttiled.default_pair_capacity(5000) == jtiled.default_pair_capacity(5000)


def test_scene_from_numpy_roundtrip(scenes):
    js, ts = scenes
    arrays = ts.to_numpy()
    for k in FIELDS:
        assert np.array_equal(arrays[k], np.asarray(getattr(js, k))), k
    assert ts.num_active == js.num_active == 700
    assert ts.num_gaussians == js.num_gaussians == 768
    _close(js.center(), ts.center())


def test_random_scene_matches_jax():
    js = j_random_scene(300, seed=9)
    ts = random_scene(300, seed=9)
    assert ts.num_gaussians == js.num_gaussians and ts.num_active == js.num_active
    for k in FIELDS:
        _close(getattr(js, k), getattr(ts, k))
    # padding: unit quaternion, scale 1, opacity 0
    assert float(ts.opacities[300:].abs().max()) == 0.0
    assert bool((ts.scales[300:] == 1.0).all()) and bool((ts.quats[300:, 0] == 1.0).all())


def test_image_utils_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-0.1, 1.1, size=(6, 5, 3)).astype(np.float32)
    b = np.clip(a + 0.01, 0, 1)
    assert np.array_equal(jimage.quantize_rgb8(a), timage.quantize_rgb8(a))
    assert jimage.encode_png(a) == timage.encode_png(a)
    assert jimage.psnr(a, b) == timage.psnr(a, b)


def test_load_ply_matches_jax():
    import os

    from gaussian_ray_tracing_tpu.scene.ply import load_ply as j_load_ply
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data", "fitted_20k.ply")
    js, ts = j_load_ply(path), load_ply(path)
    assert ts.num_active == js.num_active and ts.sh.shape == js.sh.shape
    for k in FIELDS:
        _close(getattr(js, k), getattr(ts, k))
