"""order="oddeven" and compute_dtype="bfloat16" in the port against the JAX
package on the CPU.

oddeven. The tiled march runs window_passes odd-even transposition passes
in place of the per-ray sort (JAX models/tiled.py:63-83, 188-202); JAX's
Pallas kernel has no odd-even network, so K1 composites in stream order as
in key order, with the exact event gate (the sqrt-free one needs key order
or the peak key, pallas_march.py:560-562, 966): the primary render, the
training march (K1 saved carries, K3's key replay) and the mesh tracer's
bounces. compute_dtype is read by the tiled march only; the kernel paths
ignore it.

Bars and why:
  - oddeven_perm: equal to JAX's _oddeven_perm, element for element, on
    keys with ties and inf, at 0, 1, 4 and 16 passes (integer work).
  - the tiled march on identical inputs with xla_rounding: atol 2e-5
    (tests/test_torch_tiled.py's bar).
  - render(method="plain") against render_pallas: the key-order K1 bar
    (>= 70 dB, max abs <= 1e-2); against the port's key-order frame it
    differs on the gate-edge rays only (at most 1% of them).
  - march_stream_diff against JAX's custom_vjp: forward at the K1 bar,
    gradients per written column max|a - b| / max|b| <= 1e-3, every other
    column exactly 0 (tests/test_torch_march_bwd.py's bars).
  - the mesh tracer under order and bounce_order "oddeven" against
    render_with_mesh_fast: >= 50 dB on rgb and alpha, equal block drops
    (tests/test_torch_mesh_render.py's bar).
  - bfloat16: the port's tiled march against JAX's on the same scene and
    camera >= 50 dB (measured 55.9 dB in window order and 55.6 in key
    order on random_scene(3000, seed=0) at 96x64); the kernel paths' frames
    and gradients are float32's bit for bit.
  - quality against the exact oracle within 0.1 dB of the JAX package's
    (tests/test_torch_pair_keys.py's scene and camera)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays as j_generate_rays
from gaussian_ray_tracing_tpu.config import MeshType as JMeshType
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import mesh_tracer as jtracer
from gaussian_ray_tracing_tpu.models import tiled as jtiled
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream, render_pallas
from gaussian_ray_tracing_tpu.ops.pallas_march import march_stream_diff as j_march_stream_diff
from gaussian_ray_tracing_tpu.scene import mesh as jmesh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import MeshType, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as ttracer
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import TriangleMesh
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_pair_keys import quality, quality_frame

torch.set_num_threads(1)
T = lambda x: torch.from_numpy(np.array(x))
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "sh")
SMALL_CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)


def _carry_scene(js) -> GaussianScene:
    return GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                    js.num_active)


@pytest.mark.parametrize("passes", [0, 1, 4, 16])
def test_oddeven_perm_matches_jax(passes):
    rng = np.random.default_rng(passes)
    key = rng.integers(0, 12, size=(3, 5, 37)).astype(np.float32)  # many ties
    key[rng.random(key.shape) < 0.2] = np.inf
    key[0, 0] = np.arange(37)[::-1]  # fully reversed: displacements up to 36
    want = np.asarray(jtiled._oddeven_perm(jnp.asarray(key), passes))
    got = ttiled.oddeven_perm(T(key), passes)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    sorted_ = np.take_along_axis(key, got.numpy(), -1)
    if passes >= 37:
        assert (np.diff(sorted_, axis=-1) >= 0).all()
    assert passes == 0 or not np.array_equal(got.numpy(), np.broadcast_to(np.arange(37), key.shape))


@pytest.mark.parametrize("passes", [16, 4])
def test_oddeven_tiled_march_matches_jax(passes):
    """march_tile_chunk with xla_rounding against JAX's on identical inputs
    (tests/test_torch_tiled.py's setup: 3,000 gaussians, tiles 8..23 at
    96x64, their first 256 candidates, march_chunk 64)."""
    js = j_random_scene(3000, seed=3)
    jc = JCamera.create(**SMALL_CAM)
    kw = dict(hit_multiplicity=1, order="oddeven", window_passes=passes, max_per_tile=4096,
              chunk_skip_transmittance=1e-3, march_chunk=64)
    table, binning, dirs_t, _ = jax.jit(jtiled.prepare_frame, static_argnums=(2, 3))(
        js, jc, JConfig(**kw), 200_000)
    cand = binning.cand[8:24, :256]
    g = np.asarray(table[jnp.maximum(cand, 0)])
    cand, dirs = np.asarray(cand), np.asarray(dirs_t[8:24])
    eye = np.asarray(jc.eye, np.float32)
    want = jax.jit(lambda c_, d, e, g_: jtiled.march_tile_chunk(
        c_, d, e, jtiled.unpack_columns(g_, 1), JConfig(**kw)))(cand, dirs, jnp.asarray(eye), g)
    got = ttiled.march_tile_chunk(T(cand), T(dirs), T(eye), ttiled.unpack_columns(T(g), 1),
                                  RenderConfig(**kw), xla_rounding=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)
    window = ttiled.march_tile_chunk(T(cand), T(dirs), T(eye), ttiled.unpack_columns(T(g), 1),
                                     RenderConfig(**{**kw, "order": "window"}),
                                     xla_rounding=True)
    assert np.abs(window[0].numpy() - got[0].numpy()).max() > 2e-5  # the passes leave inversions


def test_render_oddeven_matches_jax_render_pallas():
    """96x64, 800 gaussians: K1's oddeven (stream order, the exact event
    gate) against render_pallas(order="oddeven") in interpret mode."""
    js = j_random_scene(800, seed=5)
    ts = _carry_scene(js)
    kw = dict(hit_multiplicity=1, order="oddeven", march_chunk=256)
    ref = render_pallas(js, JCamera.create(**SMALL_CAM), JConfig(**kw), pair_capacity=65_536,
                        interpret=True, return_aux=True)
    out = render(ts, Camera.create(**SMALL_CAM), RenderConfig(**kw), method="plain",
                 pair_capacity=65_536, return_aux=True)
    assert out["aux"]["n_pairs"] == int(ref["aux"]["n_pairs"])
    a, b = out["rgb"].numpy(), np.asarray(ref["rgb"])
    assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 70.0
    key = render(ts, Camera.create(**SMALL_CAM), RenderConfig(**{**kw, "order": "key"}),
                 method="plain", pair_capacity=65_536)["rgb"].numpy()
    moved = np.abs(key - a).max(axis=-1) > 0.0  # the gate-edge rays
    assert moved.mean() <= 0.01


def test_march_stream_diff_oddeven_matches_jax():
    """K1 saved carries in stream order on the scalar response from the
    eye and K3's key replay: the port's march_stream_diff (plain
    versions) against JAX's custom_vjp on one JAX stream (64x48, 600
    gaussians, chunk 32); quad=True needs key order in both."""
    scene = j_random_scene(600, seed=7)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=48)
    c = 32
    prep = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pf, _, _ = prep(scene, cam, JConfig(hit_multiplicity=1), 65_536, c, False)
    _, dirs, _ = j_generate_rays(cam, JConfig())
    dirs_t = np.array(jtiled.tile_rays(dirs, 16, 16))
    starts, pf, eye = np.array(stream.starts), np.array(pf), np.array(cam.eye, np.float32)
    T_, R = dirs_t.shape[:2]
    rng = np.random.default_rng(11)
    d_rgb = rng.normal(size=dirs_t.shape).astype(np.float32)
    d_t = rng.normal(size=(T_, R)).astype(np.float32)
    kw = dict(hit_multiplicity=1, order="oddeven", march_chunk=c)
    rows = tmarch.train_features(T(pf)).requires_grad_(True)
    rgb, t_final = tbwd.march_stream_diff(rows, T(starts), T(dirs_t), T(eye), RenderConfig(**kw),
                                          c, use_kernels=False)
    (torch.sum(rgb * T(d_rgb)) + torch.sum(t_final * T(d_t))).backward()
    cfg = JConfig(**kw)
    out, vjp = jax.vjp(lambda f: j_march_stream_diff(starts, jnp.asarray(eye), f, dirs_t, cfg,
                                                      T_, R, c, True), jnp.asarray(pf))
    (j_grad,) = vjp((jnp.asarray(d_rgb), jnp.asarray(d_t)))
    for a, b in zip((rgb.detach(), t_final.detach()), out):
        a, b = a.numpy(), np.asarray(b)
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    want, got = np.asarray(j_grad), rows.grad.numpy()
    for i, col in enumerate(tmarch.TRAIN_COLUMNS):
        if col in tmarch.diff_columns(0):
            b = want[:, col]
            assert np.abs(got[:, i] - b).max() / np.abs(b).max() <= 1e-3, (i, col)
        else:
            assert not got[:, i].any(), (i, col)
    with pytest.raises(ValueError, match="quad"):
        tbwd.march_stream_diff(rows, T(starts), T(dirs_t), T(eye), RenderConfig(**kw), c,
                               use_kernels=False, quad=True)
    with pytest.raises(ValueError, match="quad"):
        j_march_stream_diff(starts, jnp.asarray(eye), jnp.asarray(pf), dirs_t, cfg, T_, R, c,
                            True, True)


def test_mesh_oddeven_matches_jax():
    """The JAX suite's TestMeshFast setup (48x32, random_scene(1200,
    seed=4), loop_bound 2, the plane at z = 1.2 as GLASS) under order and
    bounce_order "oddeven"."""
    js = j_random_scene(1200, seed=4)
    cam = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=48, height=32)
    kw = dict(hit_multiplicity=1, order="oddeven", bounce_order="oddeven", march_chunk=256,
              max_per_tile=4096, chunk_skip_transmittance=1e-3)
    jm = jmesh.make_plane(np.array([0.0, 0.0, 1.2], np.float32))
    want = jtracer.render_with_mesh_fast(js, jm, JCamera.create(**cam),
                                         JConfig(mesh_type=JMeshType.GLASS, **kw), loop_bound=2,
                                         interpret=True)
    tm = TriangleMesh.from_numpy({k: np.asarray(getattr(jm, k)) for k in
                                  ("vertices", "normals", "faces", "transform")}, jm.num_faces)
    got = ttracer.render_with_mesh_fast(_carry_scene(js), tm, Camera.create(**cam),
                                        RenderConfig(mesh_type=MeshType.GLASS, **kw),
                                        loop_bound=2, use_kernels=False)
    for k in ("rgb", "alpha"):
        assert psnr(got[k].numpy(), np.asarray(want[k])) >= 50.0, k
    assert got["aux"]["block_dropped"] == int(want["aux"]["block_dropped"])
    assert float(got["alpha"].max()) > 0.5


@pytest.mark.parametrize("order", ["window", "key"])
def test_bfloat16_tiled_march_matches_jax(order):
    scene, cam, _ = quality_frame()
    js = j_random_scene(3000, seed=0)
    kw = dict(hit_multiplicity=1, march_chunk=128, order=order, compute_dtype="bfloat16")
    jc = JCamera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    want = np.asarray(jtiled.render_tiled(js, jc, JConfig(**kw), pair_capacity=200_000)["rgb"])
    got = render(scene, cam, RenderConfig(**kw), method="tiled", pair_capacity=200_000)["rgb"]
    assert psnr(got.numpy(), want) >= 50.0


def test_bfloat16_kernel_paths_ignore_it():
    """K1 and K3's paths read no compute_dtype, as JAX's Pallas paths: the
    frame and the gradients are float32's bit for bit."""
    scene = random_scene(400, seed=2)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=48, height=32)
    outs = []
    for dtype in ("float32", "bfloat16"):
        cfg = RenderConfig(hit_multiplicity=1, compute_dtype=dtype)
        frame = render(scene, cam, cfg, method="plain")
        means = scene.means.clone().requires_grad_(True)
        moved = GaussianScene(means, *(getattr(scene, k) for k in SCENE_FIELDS[1:]),
                              num_active=scene.num_active)
        img = render_diff(moved, cam, cfg, method="plain")["rgb"]
        img.sum().backward()
        outs.append((frame["rgb"], frame["alpha"], img.detach(), means.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# the JAX package's PSNR against its exact oracle (tests/test_torch_pair_keys.py)
JAX_PSNR = {"oddeven 16 passes": (dict(order="oddeven"), 28.41),
            "oddeven 4 passes": (dict(order="oddeven", window_passes=4), 27.64),
            "bfloat16 key": (dict(order="key", compute_dtype="bfloat16"), 10.55),
            "bfloat16 window": (dict(order="window", compute_dtype="bfloat16"), 10.17),
            "bfloat16 oddeven": (dict(order="oddeven", compute_dtype="bfloat16"), 10.50)}


@pytest.mark.parametrize("name", list(JAX_PSNR) + ["plain oddeven"])
def test_quality_matches_jax(name):
    if name == "plain oddeven":  # render_pallas under oddeven: key order's 27.44
        assert abs(quality("plain", order="oddeven") - 27.44) <= 0.1
        return
    kw, want = JAX_PSNR[name]
    assert abs(quality(**kw) - want) <= 0.1
