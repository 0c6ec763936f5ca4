"""Footprints, binning and the K2 scan of the port against the JAX package.

Binning is integer work after the footprints, so fed the JAX package's own
footprints it must reproduce the JAX pair stream bit for bit. Footprints
themselves are float math: rtol 1e-5 (a few float32 ulp of association
or FMA-contraction difference between the frameworks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.ops import scan as jscan
from gaussian_ray_tracing_tpu.ops import tiles as jtiles
from gaussian_ray_tracing_tpu.ops.response import adaptive_radius as j_adaptive_radius
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops import scan as tscan
from gaussian_ray_tracing_tpu_torch.ops import tiles as ttiles
from gaussian_ray_tracing_tpu_torch.ops.response import adaptive_radius
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
                             for k in ttiles.Footprint._fields))
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
                             for k in ttiles.Footprint._fields))
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
