"""The port's tiled march (models/tiled.py, its autodiff reference) against
the JAX package's tiled march, and the port's plain K1 against it.

Bars and why:
  - bin_tiles on the JAX package's own footprints: bit-identical lists,
    counts and drop counts (integer work after the footprints).
  - march_tile_chunk on identical inputs (the JAX candidates, directions
    and feature rows) with xla_rounding: atol 2e-5 on rgb and alpha.
  - render_tiled end to end with xla_rounding (footprints, depth key,
    bin_tiles, the march, untile and clip), given the JAX package's
    primary rays and feature table: atol 2e-5 on rgb and alpha, boundary
    rays left out (float64 peak alpha within 1e-4 relative of alpha_min).
    Rays and table are substituted because the camera module's float32
    sin, cos, atan2 and norms and the table's rotation matrix round an ulp
    apart from XLA's fused code, and the response's cancellation (pp from
    |o_g|^2 ~ 1e3..1e4) turns one ulp into ~1e-4 of rgb;
    tests/test_torch_cameras.py and test_torch_ops.py hold those modules.
    With the port's own rays and table and its per-operation rounding,
    the frames agree at the kernel-vs-tiled quad bar (>= 70 dB, max abs
    <= 1e-2).
  - the port's plain K1 on the scalar response (key order, quad=False)
    against the port's tiled march: atol 2e-5 (tests/test_pallas.py:36-75,
    where JAX holds its kernel against its tiled march); quad: >= 70 dB
    and max abs <= 1e-2.
  - against the port's exact oracle: >= 40 dB (tests/test_renderers.py
    :105-160).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays as j_generate_rays
from gaussian_ray_tracing_tpu.config import CameraModel as JModel
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import tiled as jtiled
from gaussian_ray_tracing_tpu.ops import tiles as jtiles
from gaussian_ray_tracing_tpu.ops.response import adaptive_radius as j_adaptive_radius
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import render_gpu
from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle
from gaussian_ray_tracing_tpu_torch.models.renderer import render
from gaussian_ray_tracing_tpu_torch.ops import tiles as ttiles
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_march import _boundary_rays

torch.set_num_threads(1)
FIELDS = ("means", "scales", "quats", "opacities", "sh")
CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
CAP = 200_000
ATOL = 2e-5
# the JAX suite's kernel-vs-tiled config (tests/test_pallas.py:27-31)
KEY = dict(hit_multiplicity=1, order="key", max_per_tile=4096, chunk_skip_transmittance=1e-3)
T = lambda x: torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene3000():
    js = j_random_scene(3000, seed=3)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                  js.num_active)
    return js, ts


def test_bin_tiles_matches_jax(scene3000):
    """Per-tile lists, counts and drops on the JAX footprints, with both
    the per-tile cap (64) and the pair capacity (8,192 of 9,601) overflowing."""
    js, _ = scene3000
    jc, tc = JCamera.create(**CAM), Camera.create(**CAM)
    jr = j_adaptive_radius(js.opacities, 0.01)
    jfp = jtiles.project_footprints_conic(js.means, js.scales, js.quats, jr,
                                         jr * jnp.max(js.scales, axis=-1), jc, JConfig())
    tfp = ttiles.Footprint(*(T(getattr(jfp, k)) for k in ttiles.Footprint._fields[:6]))
    cap = 8192
    want = jtiles.bin_tiles(jfp, jc, JConfig(max_per_tile=64), cap)
    got = ttiles.bin_tiles(tfp, tc, RenderConfig(max_per_tile=64), cap)
    assert int(got.n_pairs) == int(want.n_pairs) > cap
    assert int(got.n_dropped) == int(want.n_dropped) > int(want.n_pairs) - cap
    assert np.array_equal(got.cand.numpy(), np.asarray(want.cand))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))
    assert int(got.counts.max()) == 64  # each list: its candidates, then -1
    assert bool(((got.cand >= 0).int().diff(dim=1) <= 0).all())


@pytest.fixture(scope="module")
def frame_inputs(scene3000):
    """The JAX prepare_frame's tiles 8..23 at SH degrees 0 and 3 (their
    first 256 candidates) as numpy arrays."""
    js, _ = scene3000
    out = {}
    for sh in (0, 3):
        cfg = JConfig(**KEY, sh_degree=sh)
        table, binning, dirs_t, _ = jax.jit(jtiled.prepare_frame, static_argnums=(2, 3))(
            js, JCamera.create(**CAM), cfg, CAP)
        cand = binning.cand[8:24, :256]
        out[sh] = dict(cand=np.asarray(cand), dirs=np.asarray(dirs_t[8:24]),
                       g=np.asarray(table[jnp.maximum(cand, 0)]))
    return out


@pytest.mark.parametrize("order,sh,hm,gate", [
    ("key", 0, 1, False), ("window", 0, 1, False), ("key", 3, 1, False),
    ("window", 3, 1, False), ("key", 0, 2, False), ("window", 0, 1, True),
])
def test_march_tile_chunk_matches_jax(frame_inputs, order, sh, hm, gate):
    """16 tiles x 256 rays x 256 candidates, march_chunk 64 (4 steps)."""
    x = frame_inputs[sh]
    kw = dict(KEY, order=order, sh_degree=sh, hit_multiplicity=hm, march_chunk=64)
    k = (sh + 1) ** 2
    jgate = tgate = None
    if gate:  # the view-depth slab [2.5, 2.7) around the shell's front
        w = np.asarray(CAM["lookat"], np.float32) - np.asarray(CAM["eye"], np.float32)
        w /= np.linalg.norm(w)
        jgate, tgate = (jnp.asarray(w), 2.5, 2.7), (torch.from_numpy(w), 2.5, 2.7)
    want = jax.jit(lambda c, d, e, g: jtiled.march_tile_chunk(
        c, d, e, jtiled.unpack_columns(g, k), JConfig(**kw), depth_gate=jgate))(
        x["cand"], x["dirs"], jnp.asarray(CAM["eye"], jnp.float32), x["g"])
    got = ttiled.march_tile_chunk(
        T(x["cand"]), T(x["dirs"]), torch.tensor(CAM["eye"]),
        ttiled.unpack_columns(T(x["g"]), k), RenderConfig(**kw), depth_gate=tgate,
        xla_rounding=True)
    assert float(got[1].max()) > 0.5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL)


@pytest.mark.parametrize("model,dist,order,sh", [
    ("pinhole", (), "window", 0), ("fisheye", (), "key", 0),
    ("opencv", (-0.25, 0.05, 0.0, 0.0), "key", 3),
])
def test_render_tiled_matches_jax(scene3000, monkeypatch, model, dist, order, sh):
    js, ts = scene3000
    kw = dict(hit_multiplicity=1, max_per_tile=4096, order=order, sh_degree=sh,
              distortion=dist)
    jcfg = JConfig(**kw, camera_model=JModel(model))
    tcfg = RenderConfig(**kw, camera_model=CameraModel(model))
    want = jtiled.render_tiled(js, JCamera.create(**CAM), jcfg, pair_capacity=CAP,
                               return_aux=True)
    rays = jax.jit(lambda c: j_generate_rays(c, jcfg))(JCamera.create(**CAM))
    table = jax.jit(lambda s: jtiled.feature_table(s, jcfg))(js)
    own = render(ts, Camera.create(**CAM), tcfg, method="tiled", pair_capacity=CAP)
    monkeypatch.setattr(ttiled, "generate_rays", lambda cam, cfg: tuple(T(r) for r in rays))
    monkeypatch.setattr(ttiled, "feature_table", lambda scene, cfg: tuple(T(x) for x in table))
    got = ttiled.render_tiled(ts, Camera.create(**CAM), tcfg, pair_capacity=CAP,
                              return_aux=True, xla_rounding=True)
    assert got["aux"] == {"n_pairs": int(want["aux"]["n_pairs"]), "n_dropped": 0}
    keep = ~_boundary_rays(js, np.asarray(rays[1]), CAM["eye"], 0.01)
    assert keep.mean() > 0.99
    a, b = got["rgb"].numpy(), np.asarray(want["rgb"])
    np.testing.assert_allclose(a[keep], b[keep], atol=ATOL)
    np.testing.assert_allclose(got["alpha"].numpy()[keep], np.asarray(want["alpha"])[keep],
                               atol=ATOL)
    a = own["rgb"].numpy()
    assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    if model == "fisheye":
        assert not own["rgb"][0, 0].any()


@pytest.mark.parametrize("sh", [0, 3])
def test_tile_chunk_does_not_change_the_frame(scene3000, sh):
    _, ts = scene3000
    cfg = RenderConfig(hit_multiplicity=1, max_per_tile=4096, march_chunk=64, sh_degree=sh)
    frames = [ttiled.render_tiled(ts, Camera.create(**CAM), cfg, tile_chunk=c,
                                  pair_capacity=CAP) for c in (1, 7, 16, 24)]
    for f in frames[1:]:
        assert torch.equal(f["rgb"], frames[0]["rgb"])
        assert torch.equal(f["alpha"], frames[0]["alpha"])


@pytest.mark.parametrize("hm,sh,model", [(1, 0, "pinhole"), (2, 0, "pinhole"),
                                         (1, 3, "pinhole"), (1, 0, "fisheye")])
def test_plain_k1_matches_tiled(scene3000, hm, sh, model):
    """K1's plain version in key order: the scalar response from the eye
    (quad=False) at atol 2e-5, the quad response at >= 70 dB and 1e-2."""
    _, ts = scene3000
    cfg = RenderConfig(**dict(KEY, hit_multiplicity=hm, sh_degree=sh),
                       camera_model=CameraModel(model))
    cam = Camera.create(**CAM)
    tiled = render(ts, cam, cfg, method="tiled", pair_capacity=CAP)
    scalar = render_gpu(ts, cam, cfg, pair_capacity=CAP, use_kernels=False, quad=False,
                        return_aux=True)
    assert scalar["aux"]["n_dropped"] == 0
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(scalar[k].numpy(), tiled[k].numpy(), atol=ATOL, err_msg=k)
    quad = render(ts, cam, cfg, method="plain", pair_capacity=CAP)
    a, b = quad["rgb"].numpy(), tiled["rgb"].numpy()
    assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    if model == "fisheye":
        assert not tiled["rgb"][0, 0].any() and not scalar["rgb"][0, 0].any()


@pytest.mark.parametrize("model,hm", [("pinhole", 1), ("fisheye", 2)])
def test_tiled_matches_oracle(model, hm):
    """The dense volumetric scene of tests/test_renderers.py:107-120."""
    scene = random_scene(2000, seed=7, extent=1.0)
    cam = Camera.create(eye=(0, 0.4, 2.6), lookat=(0, 0, 0), width=96, height=64)
    cfg = RenderConfig(camera_model=CameraModel(model), hit_multiplicity=hm,
                       max_per_tile=2048)
    out = ttiled.render_tiled(scene, cam, cfg, return_aux=True)
    assert out["aux"]["n_dropped"] == 0
    assert psnr(render_oracle(scene, cam, cfg)["rgb"].numpy(), out["rgb"].numpy()) >= 40.0


def test_tiled_config_checks():
    scene = random_scene(300, seed=1)
    cam = Camera.create(**dict(CAM, width=16, height=16))
    with pytest.raises(NotImplementedError):
        ttiled.render_tiled(scene, cam, RenderConfig(compute_dtype="int32"))
    # oddeven runs window_passes odd-even passes (tests/test_torch_oddeven.py)
    odd = ttiled.render_tiled(scene, cam, RenderConfig(order="oddeven"))
    assert odd["rgb"].shape == (16, 16, 3) and bool(torch.isfinite(odd["rgb"]).all())
    # window order sorts by t* under the peak key (tests/test_torch_peak_key.py)
    peak = ttiled.render_tiled(scene, cam, RenderConfig(window_key="peak"))
    assert peak["rgb"].shape == (16, 16, 3) and bool(torch.isfinite(peak["rgb"]).all())
    f64 = ttiled.render_tiled(scene, cam, RenderConfig(compute_dtype="float64"))
    f32 = ttiled.render_tiled(scene, cam, RenderConfig())
    assert f64["rgb"].dtype == torch.float32
    assert np.abs(f64["rgb"].numpy() - f32["rgb"].numpy()).max() < 1e-2
    # merge order composites as key in the tiled march, as in the JAX package
    merge = ttiled.render_tiled(scene, cam, RenderConfig(order="merge"))
    assert torch.equal(merge["rgb"], ttiled.render_tiled(scene, cam,
                                                         RenderConfig(order="key"))["rgb"])
