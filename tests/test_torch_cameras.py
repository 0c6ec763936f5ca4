"""The port's cameras against the JAX package's: OpenCV distortion and its
inverse, fisheye and OpenCV primary rays, and rolling-shutter rays for all
three camera models. Bar: rtol 1e-5, atol 1e-6 (float32 ulps of sin, cos,
atan2 and asin, which XLA and torch approximate differently); the fisheye
`valid` masks must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu import cameras as jcam
from gaussian_ray_tracing_tpu.config import CameraModel as JModel
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu_torch import cameras as tcam
from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig

torch.set_num_threads(1)
DIST = (-0.25, 0.05, 1e-3, -5e-4, 0.004)
TOL = dict(rtol=1e-5, atol=1e-6)
POSE0 = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0))
POSE1 = dict(eye=(0.25, 0.25, 2.8), lookat=(0.02, 0.0, 0.0))
MODELS = [("pinhole", ()), ("fisheye", ()), ("opencv", DIST), ("opencv", (-0.25, 0.05, 0, 0))]


def _configs(model, dist):
    return (JConfig(camera_model=JModel(model), distortion=dist),
            RenderConfig(camera_model=CameraModel(model), distortion=dist))


def _cams(pose, width, height):
    return (jcam.Camera.create(**pose, width=width, height=height),
            tcam.Camera.create(**pose, width=width, height=height))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_distortion_and_its_inverse_match_jax():
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(-0.7, 0.7, size=(40, 30)).astype(np.float32) for _ in range(2))
    for dist in (DIST, (-0.25, 0.05, 0, 0), (0.1, -0.02, 0, 0, 0, 0.01, 0.002, 0.001)):
        jd = jcam.distort_opencv(jnp.asarray(x), jnp.asarray(y), dist)
        td = tcam.distort_opencv(torch.from_numpy(x), torch.from_numpy(y), dist)
        for a, b in zip(td, jd):
            _close(a, b)
        ju = jcam.undistort_opencv(jd[0], jd[1], dist)
        tu = tcam.undistort_opencv(td[0], td[1], dist)
        for a, b, orig in zip(tu, ju, (x, y)):
            _close(a, b)
            np.testing.assert_allclose(a.numpy(), orig, atol=1e-4)  # a true inverse


@pytest.mark.parametrize("model,dist", MODELS)
@pytest.mark.parametrize("size", [(96, 64), (64, 64)])
def test_generate_rays_match_jax(model, dist, size):
    jc, tc = _cams(POSE0, *size)
    jcfg, tcfg = _configs(model, dist)
    jo, jd, jv = jcam.generate_rays(jc, jcfg)
    to, td, tv = tcam.generate_rays(tc, tcfg)
    _close(to, jo)
    _close(td, jd)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    if model == "fisheye":
        assert 0 < int(tv.sum()) < tv.numel()  # the r > 1 ring is blanked
        assert not td[~tv].any()


@pytest.mark.parametrize("model,dist", MODELS)
def test_rolling_rays_match_jax(model, dist):
    jc0, tc0 = _cams(POSE0, 64, 48)
    jc1, tc1 = _cams(POSE1, 64, 48)
    jcfg, tcfg = _configs(model, dist)
    jo, jd, jv = jcam.generate_rays_rolling(jc0, jc1, jcfg)
    to, td, tv = tcam.generate_rays_rolling(tc0, tc1, tcfg)
    _close(to, jo)
    _close(td, jd)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    # a static shutter is the global-shutter frame
    so, sd, sv = tcam.generate_rays_rolling(tc0, tc0, tcfg)
    go, gd, gv = tcam.generate_rays(tc0, tcfg)
    torch.testing.assert_close(sd, gd, **TOL)
    torch.testing.assert_close(so, go, **TOL)
    assert torch.equal(sv, gv)


def test_lerp_camera_matches_jax():
    jc0, tc0 = _cams(POSE0, 32, 24)
    jc1, tc1 = _cams(POSE1, 32, 24)
    j, t = jcam.lerp_camera(jc0, jc1, 0.5), tcam.lerp_camera(tc0, tc1, 0.5)
    for k in ("eye", "lookat", "up"):
        _close(getattr(t, k), getattr(j, k))
    assert (t.width, t.height, t.fov_y_deg) == (j.width, j.height, j.fov_y_deg)
