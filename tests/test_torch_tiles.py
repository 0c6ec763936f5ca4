"""Footprints (pinhole, fisheye, OpenCV), binning and the K2 scan of the
port against the JAX package.

Binning is integer work after the footprints, so fed the JAX package's own
footprints it must reproduce the JAX pair stream bit for bit. Footprints
themselves are float math: rtol 1e-5 (a few float32 ulp of association
or FMA-contraction difference between the frameworks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import CameraModel as JModel
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.ops import scan as jscan
from gaussian_ray_tracing_tpu.ops import tiles as jtiles
from gaussian_ray_tracing_tpu.ops.response import adaptive_radius as j_adaptive_radius
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig
from gaussian_ray_tracing_tpu_torch.ops import scan as tscan
from gaussian_ray_tracing_tpu_torch.ops import tiles as ttiles
from gaussian_ray_tracing_tpu_torch.ops.response import (
    adaptive_radius, canonical_frames, ray_ellipsoid_span,
)
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

torch.set_num_threads(1)
FIELDS = ("means", "scales", "quats", "opacities", "sh")
# (n gaussians, seed, width, height, pair capacity)
CASES = [(800, 5, 96, 64, 65_536), (5000, 3, 256, 256, 1 << 18)]


def _setup(n, seed, width, height):
    js = j_random_scene(n, seed=seed)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                  js.num_active)
    kw = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=width, height=height)
    return js, ts, JCamera.create(**kw), Camera.create(**kw)


def _footprints(js, ts, jc, tc):
    jr = j_adaptive_radius(js.opacities, 0.01)
    jfp = jtiles.project_footprints_conic(js.means, js.scales, js.quats, jr,
                                         jr * jnp.max(js.scales, axis=-1), jc, JConfig())
    tr = adaptive_radius(ts.opacities, 0.01)
    tfp = ttiles.project_footprints_conic(ts.means, ts.scales, ts.quats, tr,
                                          tr * ts.scales.amax(dim=-1), tc, RenderConfig())
    return jfp, tfp


@pytest.mark.parametrize("case", CASES[:1])
def test_footprints_match_jax(case):
    js, ts, jc, tc = _setup(*case[:4])
    jfp, tfp = _footprints(js, ts, jc, tc)
    for k in ("px", "py", "rx", "ry", "depth"):
        np.testing.assert_allclose(getattr(tfp, k).numpy(), np.asarray(getattr(jfp, k)),
                                   rtol=1e-5, err_msg=k)
    assert np.array_equal(tfp.visible.numpy(), np.asarray(jfp.visible))
    assert int(ttiles.count_pairs(ts, tc, RenderConfig())) == \
        int(jtiles.count_pairs(js, jc, JConfig()))


@pytest.mark.parametrize("case", CASES)
def test_binning_on_jax_footprints_is_bit_identical(case):
    n, seed, width, height, cap = case
    js, ts, jc, tc = _setup(n, seed, width, height)
    jfp, _ = _footprints(js, ts, jc, tc)
    js_stream = jtiles.bin_pairs(jfp, jc, JConfig(), cap)
    tfp = ttiles.Footprint(*(torch.from_numpy(np.array(getattr(jfp, k)))
                             for k in ttiles.Footprint._fields[:6]))
    ts_stream = ttiles.bin_pairs(tfp, tc, RenderConfig(), cap)

    n_pairs = int(js_stream.n_pairs)
    assert int(ts_stream.n_pairs) == n_pairs > 0
    assert int(ts_stream.n_dropped) == int(js_stream.n_dropped) == 0
    assert np.array_equal(ts_stream.order.numpy(), np.asarray(js_stream.order))
    assert np.array_equal(ts_stream.starts.numpy(), np.asarray(js_stream.starts))
    assert np.array_equal(ts_stream.gid.numpy()[:n_pairs],
                          np.asarray(js_stream.gid)[:n_pairs])
    assert np.array_equal(ts_stream.key.numpy()[:n_pairs],
                          np.asarray(js_stream.key)[:n_pairs])
    assert bool((ts_stream.gid[n_pairs:] == -1).all())


def test_binning_overflow_counts_dropped_pairs():
    js, ts, jc, tc = _setup(800, 5, 96, 64)
    jfp, _ = _footprints(js, ts, jc, tc)
    tfp = ttiles.Footprint(*(torch.from_numpy(np.array(getattr(jfp, k)))
                             for k in ttiles.Footprint._fields[:6]))
    cap = 1000
    j = jtiles.bin_pairs(jfp, jc, JConfig(), cap)
    t = ttiles.bin_pairs(tfp, tc, RenderConfig(), cap)
    assert int(t.n_dropped) == int(j.n_dropped) > 0
    assert np.array_equal(t.starts.numpy(), np.asarray(j.starts))
    assert np.array_equal(t.gid.numpy(), np.asarray(j.gid))


def _wrapping_int32(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-1000, 1000, size=shape, dtype=np.int64)
    x[:, ::97] = rng.integers(2**31 - 50, 2**31, size=x[:, ::97].shape)  # sums wrap
    x[:, 5::131] = rng.integers(-2**31, -2**31 + 50, size=x[:, 5::131].shape)
    return x.astype(np.int32)


@pytest.mark.parametrize("shape", [(2, 40_000), (16, 1234)])
def test_plain_scan_matches_jax_exactly(shape):
    x = _wrapping_int32(shape, shape[0])
    got = tscan.multi_cumsum_i32(torch.from_numpy(x)).numpy()  # CPU: plain version
    assert np.array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))
    assert np.array_equal(got, np.asarray(jscan.multi_cumsum_i32(jnp.asarray(x),
                                                                 interpret=True)))


def test_multi_head_fill_matches_jax():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 5, size=300)
    first = np.minimum(np.cumsum(counts) - counts, 600).astype(np.int32)
    values = [rng.integers(-2**31, 2**31 - 1, size=300).astype(np.int32)
              for _ in range(3)]
    j = jscan.multi_head_fill(jnp.asarray(first), [jnp.asarray(v) for v in values],
                              600, use_kernel=False)
    t = tscan.multi_head_fill(torch.from_numpy(first),
                              [torch.from_numpy(v) for v in values], 600)
    for a, b in zip(j, t):
        assert np.array_equal(b.numpy(), np.asarray(a))


def test_scan_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        tscan.multi_cumsum_i32(torch.zeros((17, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tscan.multi_cumsum_i32(torch.zeros((2, 8), dtype=torch.int64))


# --- fisheye and OpenCV footprints ----------------------------------------

CAMERAS = [("fisheye", ()), ("opencv", (-0.25, 0.05, 0.0, 0.0)),
           ("opencv", (-0.18, 0.03, 1e-3, -5e-4, 0.004))]
# Fisheye px, py, rx, ry all come from the cone caps' float32 Cardano
# eigen-solve (the rect's centre too: it is the midpoint of the cap's
# polar rectangle). Both packages run it in the same operation order; they
# differ where the host's float32 sqrt, acos and cos round differently
# (torch's vectorised CPU sqrt is not always correctly rounded; XLA's acos
# and cos are other approximations than torch's), and the solve amplifies
# an ulp at ill-conditioned caps: on the 998 visible gaussians of the case
# below both sit up to 3.4e-4 (px), 4.3e-4 (py), 2.6e-3 (rx) and 2.4e-3
# (ry) from a float64 evaluation of the same function, a quarter of the
# extents more than 1e-5 from it, so a bar against the other package
# depends on the host. The witness bar below does not: the port may be no
# further from float64 than 1.25x the JAX package, field by field (as K3's
# bar reads), and at least 98% of the four fields' values stay within rtol
# 1e-5 of JAX. Invisible slots are left out: the binning never reads
# their rects (ops/tiles._tile_rects; test_binning_ignores_invisible_rects).
FISHEYE_WITNESS_RATIO, FISHEYE_SHARE = 1.25, 0.98


def _configs(model, dist):
    return (JConfig(camera_model=JModel(model), distortion=dist),
            RenderConfig(camera_model=CameraModel(model), distortion=dist))


def _port_footprints(ts, tc, tcfg, dtype=torch.float32):
    """The port's footprints of scene `ts` from camera `tc`, evaluated in
    `dtype` (float64: the witness)."""
    cam = Camera(tc.eye.to(dtype), tc.lookat.to(dtype), tc.up.to(dtype), tc.fov_y_deg,
                 tc.width, tc.height)
    means, scales, quats, opacities = (x.to(dtype) for x in
                                       (ts.means, ts.scales, ts.quats, ts.opacities))
    r = adaptive_radius(opacities, 0.01)
    return ttiles.project_footprints_conic(means, scales, quats, r, r * scales.amax(dim=-1),
                                           cam, tcfg)


@pytest.mark.parametrize("model,dist", CAMERAS)
def test_camera_footprints_match_jax(model, dist):
    """px, py, rx, ry and depth at rtol 1e-5 (fisheye: depth at rtol 1e-5,
    the rect under the float64 witness bar above); visibility and the
    frame's pair count identical."""
    js, ts, jc, tc = _setup(1000, 5, 96, 64)
    jcfg, tcfg = _configs(model, dist)
    jr = j_adaptive_radius(js.opacities, 0.01)
    jfp = jtiles.project_footprints_conic(js.means, js.scales, js.quats, jr,
                                         jr * jnp.max(js.scales, axis=-1), jc, jcfg)
    tfp = _port_footprints(ts, tc, tcfg)
    vis = tfp.visible.numpy()
    assert np.array_equal(vis, np.asarray(jfp.visible))
    assert int(ttiles.count_pairs(ts, tc, tcfg)) == int(jtiles.count_pairs(js, jc, jcfg))
    rect = ("px", "py", "rx", "ry") if model == "fisheye" else ()
    for k in ("px", "py", "rx", "ry", "depth"):
        if k not in rect:
            np.testing.assert_allclose(getattr(tfp, k).numpy(), np.asarray(getattr(jfp, k)),
                                       rtol=1e-5, err_msg=k)
    if not rect:
        return
    w64 = _port_footprints(ts, tc, tcfg, torch.float64)
    assert np.array_equal(w64.visible.numpy(), vis)
    close = []
    for k in rect:
        w = getattr(w64, k).numpy()[vis]
        got = getattr(tfp, k).numpy()[vis].astype(np.float64)
        want = np.asarray(getattr(jfp, k))[vis].astype(np.float64)
        err_port = np.max(np.abs(got - w) / np.abs(w))
        err_jax = np.max(np.abs(want - w) / np.abs(w))
        assert err_port <= FISHEYE_WITNESS_RATIO * err_jax, (k, err_port, err_jax)
        close.append(np.abs(got - want) <= 1e-5 * np.abs(want))
    assert np.mean(np.concatenate(close)) >= FISHEYE_SHARE


def test_binning_ignores_invisible_rects():
    """An invisible gaussian's px, py, rx, ry never reach the pair stream:
    _tile_rects gives it no pairs, and its zero-count head-fill deltas
    telescope away. Scrambling them (NaN, inf, huge) changes nothing."""
    js, ts, jc, tc = _setup(1000, 5, 96, 64)
    cfg = _configs("fisheye", ())[1]
    fp = _port_footprints(ts, tc, cfg)
    hidden = ~fp.visible
    assert int(hidden.sum()) > 0
    rng = np.random.default_rng(3)
    junk = lambda v: torch.where(hidden, torch.from_numpy(
        rng.choice(np.float32([np.nan, np.inf, -1e30, 0.0, 7.5]), size=v.shape)), v)
    scrambled = fp._replace(px=junk(fp.px), py=junk(fp.py), rx=junk(fp.rx), ry=junk(fp.ry))
    a = ttiles.bin_pairs(fp, tc, cfg, 1 << 16)
    b = ttiles.bin_pairs(scrambled, tc, cfg, 1 << 16)
    for k in ("gid", "key", "starts", "order", "n_pairs", "n_dropped"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("model,dist,n,seed,size", [
    ("fisheye", (), 400, 3, (128, 128)),
    ("opencv", (-0.18, 0.03, 1e-3, -5e-4, 0.004), 300, 5, (96, 64)),
])
def test_footprints_contain_every_hit_pixel(model, dist, n, seed, size):
    """Brute force (tests/test_footprints.py TestFisheyeConeCaps,
    tests/test_distortion.py test_footprint_containment): no pixel whose
    ray meets a gaussian's iso-ellipsoid ahead of the eye (alpha >
    alpha_min along it) lies outside that gaussian's rect."""
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    scene = random_scene(n, seed=seed)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=size[0],
                        height=size[1])
    cfg = RenderConfig(camera_model=CameraModel(model), distortion=dist)
    radius = adaptive_radius(scene.opacities, cfg.alpha_min)
    fp = ttiles.project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                         radius * scene.scales.amax(dim=-1), cam, cfg)
    M = canonical_frames(scene.scales, scene.quats)
    _, dirs, valid = generate_rays(cam, cfg)
    d = dirs.reshape(1, -1, 3)
    ys, xs = torch.meshgrid(torch.arange(size[1]) + 0.5, torch.arange(size[0]) + 0.5,
                            indexing="ij")
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    bad = hits = 0
    for g in torch.arange(scene.num_gaussians).split(64):
        hit, _, t_out = ray_ellipsoid_span(scene.means[g, None], M[g, None], radius[g, None],
                                           cam.eye, d)
        mask = hit & (t_out > 0) & valid.reshape(1, -1)
        inside = ((xs - fp.px[g, None]).abs() <= fp.rx[g, None]) \
            & ((ys - fp.py[g, None]).abs() <= fp.ry[g, None])
        hits += int(mask.sum())
        bad += int((mask & ~inside).sum())
    assert hits > 10_000 and bad == 0
