"""window_key="peak" in the port against the JAX package on the CPU: K1's
plain march against `pallas_march_stream` in interpret mode (window and
merge order on the quad response of full-range rays, where the gate is the
sqrt-free one; the scalar response from the eye and the quad response
from per-ray origins, where it stays the event gate), K3's window replay
through `march_stream_diff` against JAX's custom_vjp, and the tiled
march's window order.

The peak key orders by t* (the maximum response along the ray) in place
of the event t (pallas_march.py:552-575, 672-675, 1343-1360; models/
tiled.py:199). Bars: the files' own, tests/test_torch_march.py's for K1
(PSNR >= 70 dB and max abs <= 1e-2), tests/test_torch_march_bwd.py's for
K3 (per written column max|a - b| / max|b| <= 1e-3, every other column
exactly 0), tests/test_torch_tiled.py's for the tiled march (atol 2e-5
with xla_rounding). Each case also shows that the key moves the image (or
the gradient) against the event key by more than the bar's residual."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import tiled as jtiled
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import march_stream_diff as j_march_stream_diff
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
C = 128
PEAK = dict(hit_multiplicity=1, march_chunk=C, window_key="peak")
T_ = lambda x: torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def inp():
    """One JAX pair stream (96x64, 800 gaussians, 16x16 tiles) and per-ray
    origins about the eye, as numpy arrays."""
    scene = j_random_scene(800, seed=5)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, _, _ = prepare(scene, cam, JConfig(hit_multiplicity=1), 65_536, C, False)
    _, dirs, _ = generate_rays(cam, JConfig())
    dirs_t = np.array(tile_rays(dirs, 16, 16))
    rng = np.random.default_rng(4)
    eye = np.array(cam.eye, np.float32)
    origins = (eye + 0.02 * rng.normal(size=dirs_t.shape)).astype(np.float32)
    return dict(starts=np.array(stream.starts), eye=eye, pair_feats=np.array(pair_feats),
                dirs_t=dirs_t, origins_t=origins)


def _assert_bars(got, want):
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


# (order, response): quad on full-range rays (the sqrt-free gate), the
# scalar response from the eye and the quad response from per-ray origins
# (the event gate)
CASES = [("window", "quad"), ("merge", "quad"), ("window", "scalar"),
         ("window", "origin_quad")]


def _both(inp, order, response, key, with_jax=True):
    kw = dict(PEAK, order=order, window_key=key)
    T, R = inp["dirs_t"].shape[:2]
    starts, feats, dirs_t = T_(inp["starts"]), T_(inp["pair_feats"]), T_(inp["dirs_t"])
    jkw, tkw = dict(quad=response != "scalar"), {}
    if response == "quad":
        rows = tmarch.compact_features(feats)
        jkw["packed16"] = False
    elif response == "scalar":  # the port's scalar response takes per-ray origins: the eye
        rows = tmarch.scalar_features(feats)
        tkw["origins_t"] = T_(inp["eye"]).expand(dirs_t.shape).contiguous()
    else:
        rows = tmarch.train_features(feats)
        jkw["origins_t"] = inp["origins_t"]
        tkw = dict(origins_t=T_(inp["origins_t"]), quad=True)
    got = tmarch.march(starts, rows, dirs_t, RenderConfig(**kw), C, **tkw)
    if not with_jax:
        return got, None
    want = pallas_march_stream(inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"],
                               JConfig(**kw), n_tiles=T, rays_per_tile=R, chunk=C,
                               interpret=True, **jkw)
    return got, want


@pytest.mark.parametrize("order,response", CASES)
def test_peak_key_march_matches_pallas(inp, order, response):
    got, want = _both(inp, order, response, "peak")
    _assert_bars(got, want)
    event = _both(inp, order, response, "event", with_jax=False)[0]
    # the key really moves the image: by more than the bar's residual
    assert np.abs(got[0].numpy() - event[0].numpy()).max() > 1e-2
    assert float(got[1].min()) < 0.5


def test_peak_key_replay_matches_pallas():
    """K3's window replay sorts by t* with the forward's quantization and
    unique key, the gate the event gate: the port's march_stream_diff
    (plain versions; the scalar response from the eye) against JAX's
    custom_vjp, forward and gradient of the pair features, on the 64x48 /
    600-gaussian stream of tests/test_torch_train_modes.py at chunk 32."""
    scene = j_random_scene(600, seed=7)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=48)
    c = 32
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pf, _, _ = prepare(scene, cam, JConfig(hit_multiplicity=1), 65_536, c, False)
    _, dirs, _ = generate_rays(cam, JConfig())
    dirs_t, starts, pf = np.array(tile_rays(dirs, 16, 16)), np.array(stream.starts), np.array(pf)
    eye = np.array(cam.eye, np.float32)
    T, R = dirs_t.shape[:2]
    rng = np.random.default_rng(11)
    d_rgb = rng.normal(size=dirs_t.shape).astype(np.float32)
    d_t = rng.normal(size=(T, R)).astype(np.float32)
    grads, fwd = {}, {}
    for key in ("peak", "event"):
        kw = dict(hit_multiplicity=1, order="window", march_chunk=c, window_key=key)
        rows = tmarch.train_features(T_(pf)).requires_grad_(True)
        before = tbwd.march_bwd.peak_launches
        rgb, t_final = tbwd.march_stream_diff(rows, T_(starts), T_(dirs_t), T_(eye),
                                              RenderConfig(**kw), c, use_kernels=False)
        (torch.sum(rgb * T_(d_rgb)) + torch.sum(t_final * T_(d_t))).backward()
        assert tbwd.march_bwd.peak_launches == before  # the plain versions on the CPU
        fwd[key], grads[key] = (rgb.detach(), t_final.detach()), rows.grad.numpy()
        if key == "peak":
            cfg = JConfig(**kw)
            out, vjp = jax.vjp(lambda f: j_march_stream_diff(
                starts, jnp.asarray(eye), f, dirs_t, cfg, T, R, c, True), jnp.asarray(pf))
            (j_grad,) = vjp((jnp.asarray(d_rgb), jnp.asarray(d_t)))
            _assert_bars(fwd[key], out)
            want = np.asarray(j_grad)
            for i, col in enumerate(tmarch.TRAIN_COLUMNS):
                if col in tmarch.diff_columns(0):
                    b = want[:, col]
                    assert np.abs(grads[key][:, i] - b).max() / np.abs(b).max() <= 1e-3, (i, col)
                else:
                    assert not grads[key][:, i].any(), (i, col)
    # the replay's key moves the gradient by more than the bar
    g, e = grads["peak"], grads["event"]
    assert np.abs(g - e).max() / np.abs(e).max() > 1e-3


def test_peak_key_tiled_march_matches_jax():
    """The tiled march's window order sorts by t*: march_tile_chunk with
    xla_rounding against JAX's on identical inputs (tests/test_torch_tiled.py's
    setup: 3,000 gaussians, tiles 8..23 at 96x64, their first 256
    candidates, march_chunk 64), atol 2e-5."""
    js = j_random_scene(3000, seed=3)
    jc = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    kw = dict(hit_multiplicity=1, order="window", max_per_tile=4096,
              chunk_skip_transmittance=1e-3, march_chunk=64)
    table, binning, dirs_t, _ = jax.jit(jtiled.prepare_frame, static_argnums=(2, 3))(
        js, jc, JConfig(**kw), 200_000)
    cand = binning.cand[8:24, :256]
    g = np.asarray(table[jnp.maximum(cand, 0)])
    cand, dirs = np.asarray(cand), np.asarray(dirs_t[8:24])
    eye = np.asarray(jc.eye, np.float32)
    out = {}
    for key in ("peak", "event"):
        want = jax.jit(lambda c_, d, e, g_: jtiled.march_tile_chunk(
            c_, d, e, jtiled.unpack_columns(g_, 1), JConfig(**kw, window_key=key)))(
            cand, dirs, jnp.asarray(eye), g)
        got = ttiled.march_tile_chunk(T_(cand), T_(dirs), T_(eye), ttiled.unpack_columns(T_(g), 1),
                                      RenderConfig(**kw, window_key=key), xla_rounding=True)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)
        out[key] = got[0].numpy()
    assert np.abs(out["peak"] - out["event"]).max() > 1e-2
