"""Per-pair sort keys (config.pair_keys "tile", "tile_peak" and "affine") in
the port against the JAX package on the CPU: the binning, the branch
structure of bin_pairs, the primary render against render_pallas
(interpret mode), the tiled march against JAX's, the gradients of the
training render, and the quality against the exact oracle.

Bars and why:
  - affine binning: fed JAX's own footprints and (a_q, bc_q), the port's
    _bin_pairs_affine gives JAX's stream bit for bit (gid, packed keys,
    starts, n_pairs, n_dropped): integer work after the keys.
  - affine_tile_keys: the port's (a_q, bc_q) against JAX's. The model is
    float math (log, sqrt, round, XLA's fused products); at most 0.5% of
    the gaussians may differ, each by one step. Measured on
    random_scene(3000, seed=0) at 256x256: none differs (pinhole and
    OpenCV).
  - tile and tile_peak binning (pinhole, fisheye, OpenCV): starts,
    n_pairs, n_dropped, each slot's tile and each tile's set of gaussian
    ids are exact; the quantized keys are exact on all but KEY_SHARE of
    the pairs, each within KEY_STEPS steps. Measured (same scene): "tile"
    0.39%, 0.20% and 0.31% of the pairs (pinhole, fisheye, OpenCV), at most
    2 steps (fisheye); "tile_peak" 0.09%, 0.14% and 0.10%, one step. XLA's
    CPU backend fuses the per-pair math and contracts products into FMAs
    where the port rounds each float32 operation; "tile"'s entry takes the
    square root of a cancelling discriminant, and the fisheye tile rays go
    through XLA's own asin, atan2, sin and cos.
  - render(method="plain") against render_pallas: the K1 CPU bars of
    tests/test_torch_render.py (window order >= 60 dB on rgb and alpha;
    key order >= 70 dB and max abs <= 1e-2), on every tile but those
    whose stream order differs between the packages (a one-step key
    difference that swaps two pairs of one tile: the sort-boundary tiles,
    at most 2 of the 24 here), with equal pair counts.
  - render_tiled with xla_rounding against JAX's render_tiled, given JAX's
    rays and feature table (tests/test_torch_tiled.py's bar: atol 2e-5,
    boundary rays and sort-boundary tiles left out), but for one pixel's
    rgb (RGB_TAIL: at most 3 entries, within 2e-3): on this scene pixel
    (29, 62), a terminated ray whose alpha agrees to the bit, differs by
    1.28e-3 under the default pair_keys="gaussian" as well, where the
    composite meets the min_transmittance cutoff.
  - gradients under "tile" in key and window order against
    render_pallas_diff: tests/test_torch_train.py's bars (per raw field
    max|a - b| / max|b| <= 1e-3, loss rtol 1e-4), the boundary rays and
    the sort-boundary tiles left out of the loss on both sides.
  - quality: the port's tiled march against its exact oracle within 0.1 dB
    of the JAX package's PSNR on the same scene and camera
    (scripts/key_quality.py: random_scene(3000, seed=0), 96x64, eye (0,
    0.3, 2.8), hit_multiplicity 1, chunk 128)."""

import functools

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
from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JGaussianModel
from gaussian_ray_tracing_tpu.models.pallas_renderer import (
    prepare_pair_stream, render_pallas, render_pallas_diff,
)
from gaussian_ray_tracing_tpu.ops import tiles as jtiles
from gaussian_ray_tracing_tpu.ops.response import ray_ellipsoid_span as j_span
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import bin_frame, render_gpu
from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
from gaussian_ray_tracing_tpu_torch.models.rolling import render_rolling
from gaussian_ray_tracing_tpu_torch.ops import tiles as ttiles
from gaussian_ray_tracing_tpu_torch.parallel.mesh import make_mesh
from gaussian_ray_tracing_tpu_torch.parallel.sharded import render_pallas_sharded
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_march import _boundary_rays

torch.set_num_threads(1)
T = lambda x: torch.from_numpy(np.array(x))
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "sh")
KEYS = ("tile", "tile_peak", "affine")
MODELS = {"pinhole": (), "fisheye": (), "opencv": (-0.2, 0.05, 0.0, 0.0)}
BIN_CAM = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256)
BIN_CAP = 1 << 17  # the frames emit 39,440 to 50,106 pairs
KEY_SHARE, KEY_STEPS = 0.005, 2
SMALL_CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)


def _configs(model: str, **kw):
    dist = MODELS[model]
    return (JConfig(camera_model=JModel(model), distortion=dist, **kw),
            RenderConfig(camera_model=CameraModel(model), distortion=dist, **kw))


@functools.lru_cache(maxsize=None)
def _jax_binning_inputs(model: str):
    """JAX's footprints with its central-ray depth key and its geometry
    (means, M9, radius), as its renderers bin them, on random_scene(3000,
    seed=0) at 256x256, and the same as torch tensors."""
    js = j_random_scene(3000, seed=0)
    jcfg, _ = _configs(model)
    jc = JCamera.create(**BIN_CAM)
    _, M, radius = jtiled.feature_table(js, jcfg)
    fp = jtiles.project_footprints_conic(js.means, js.scales, js.quats, radius,
                                        radius * jnp.max(js.scales, axis=-1), jc, jcfg)
    rel = js.means - jc.eye
    rho = jnp.maximum(jnp.linalg.norm(rel, axis=-1), 1e-9)
    hit, t_in, t_out = j_span(js.means, M, radius, jc.eye, rel / rho[:, None])
    fp = fp._replace(depth=jnp.where(hit, jnp.where(t_in >= jcfg.t_min, t_in, t_out), rho))
    geom = (js.means, M.reshape(-1, 9), radius)
    tfp = ttiles.Footprint(*(T(getattr(fp, k)) for k in ttiles.Footprint._fields[:6]))
    return fp, geom, tfp, tuple(T(g) for g in geom)


def _tile_sets_equal(starts, gid_a, gid_b) -> bool:
    return all(np.array_equal(np.sort(gid_a[a:b]), np.sort(gid_b[a:b]))
               for a, b in zip(starts[:-1], starts[1:]))


@pytest.mark.parametrize("keys", ["tile", "tile_peak"])
@pytest.mark.parametrize("model", list(MODELS))
def test_tile_key_binning_matches_jax(model, keys):
    fp, geom, tfp, tgeom = _jax_binning_inputs(model)
    jcfg, tcfg = _configs(model, pair_keys=keys)
    want = jtiles.bin_pairs(fp, JCamera.create(**BIN_CAM), jcfg, BIN_CAP, geom=geom)
    got = ttiles.bin_pairs(tfp, Camera.create(**BIN_CAM), tcfg, BIN_CAP, geom=tgeom)
    n = int(want.n_pairs)
    assert int(got.n_pairs) == n > 30_000 and int(got.n_dropped) == int(want.n_dropped) == 0
    assert got.order is None and want.order is None
    starts = np.asarray(want.starts)
    assert np.array_equal(got.starts.numpy(), starts)
    jg, tg = np.asarray(want.gid)[:n], got.gid.numpy()[:n]
    assert _tile_sets_equal(starts, jg, tg)
    assert bool((got.gid[n:] == -1).all())
    _, depth_bits = ttiles._depth_bits(starts.shape[0] - 1)
    jk, tk = np.asarray(want.key)[:n], got.key.numpy()[:n]
    assert np.array_equal(jk >> depth_bits, tk >> depth_bits)  # each slot's tile
    mask = (1 << depth_bits) - 1
    jd = dict(zip(zip(jk >> depth_bits, jg), jk & mask))
    diff = np.array([int(k & mask) - int(jd[(t, g)]) for k, t, g in zip(tk, tk >> depth_bits, tg)])
    assert np.mean(diff != 0) <= KEY_SHARE and np.abs(diff).max() <= KEY_STEPS


def _affine_keys(model: str):
    fp, geom, tfp, tgeom = _jax_binning_inputs(model)
    jcfg, tcfg = _configs(model, pair_keys="affine")
    _, depth_bits = ttiles._depth_bits(16 * 16)
    jkey = jtiles.affine_tile_keys(geom[0], geom[1], fp, JCamera.create(**BIN_CAM), jcfg,
                                   depth_bits)
    tkey = ttiles.affine_tile_keys(tgeom[0], tgeom[1], tfp, Camera.create(**BIN_CAM), tcfg,
                                   depth_bits)
    return jkey, tkey


@pytest.mark.parametrize("model,cap", [("pinhole", BIN_CAP), ("fisheye", BIN_CAP),
                                       ("pinhole", 20_000)])
def test_affine_binning_is_exact_on_jax_keys(model, cap):
    """On JAX's footprints and (a_q, bc_q) the port's affine binning (the
    four head fills in one multi-channel scan) gives JAX's stream, also
    when the capacity drops pairs; fisheye takes the constant fallback."""
    fp, geom, tfp, _ = _jax_binning_inputs(model)
    jcfg, tcfg = _configs(model, pair_keys="affine")
    want = jtiles.bin_pairs(fp, JCamera.create(**BIN_CAM), jcfg, cap, geom=geom)
    (ja, jbc), _ = _affine_keys(model)
    got = ttiles._bin_pairs_affine(tfp, Camera.create(**BIN_CAM), tcfg, cap, (T(ja), T(jbc)))
    assert int(got.n_pairs) == int(want.n_pairs) > 30_000
    assert int(got.n_dropped) == int(want.n_dropped) == max(int(want.n_pairs) - cap, 0)
    for k in ("gid", "key", "starts"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k
    if model == "fisheye":  # no model off pinhole: every slope is zero
        assert bool((jbc == (4096 << 13 | 4096)).all())


@pytest.mark.parametrize("model", ["pinhole", "opencv"])
def test_affine_tile_keys_match_jax(model):
    """The port's affine model against JAX's (module docstring: measured
    exact), and the port's own end-to-end affine stream against JAX's."""
    (ja, jbc), (ta, tbc) = _affine_keys(model)
    ja, jbc, ta, tbc = (np.asarray(x).astype(np.int64) for x in (ja, jbc, ta, tbc))
    off = (ja != ta) | (jbc != tbc)
    assert off.mean() <= KEY_SHARE
    assert np.abs(ja - ta).max() <= 1
    assert np.abs((jbc >> 13) - (tbc >> 13)).max() <= 1
    assert np.abs((jbc & 8191) - (tbc & 8191)).max() <= 1
    if model == "opencv":  # the constant key with zero slopes
        assert bool((tbc == (4096 << 13 | 4096)).all())
    else:
        assert len(np.unique(tbc)) > 100
    fp, geom, tfp, tgeom = _jax_binning_inputs(model)
    jcfg, tcfg = _configs(model, pair_keys="affine")
    want = jtiles.bin_pairs(fp, JCamera.create(**BIN_CAM), jcfg, BIN_CAP, geom=geom)
    got = ttiles.bin_pairs(tfp, Camera.create(**BIN_CAM), tcfg, BIN_CAP, geom=tgeom)
    assert np.array_equal(got.starts.numpy(), np.asarray(want.starts))
    if not off.any():
        assert np.array_equal(got.gid.numpy(), np.asarray(want.gid))
        assert np.array_equal(got.key.numpy(), np.asarray(want.key))


@pytest.mark.parametrize("keys", KEYS)
def test_branch_structure(keys):
    """JAX's bin_pairs branches (ops/tiles.py:1622-1660): under a pair key
    the culls are ignored; tile_rows with geom raises; without geom the
    gaussian key bins, so the ray-band renderer and the rolling shutter
    keep it while the single-device frame takes the pair key."""
    for model, culls in (("pinhole", dict(conic_cull=True, row_span=True)),
                         ("fisheye", dict(fisheye_cull=True))):
        _, _, tfp, tgeom = _jax_binning_inputs(model)
        _, tcfg = _configs(model, pair_keys=keys)
        cam = Camera.create(**BIN_CAM)
        plain = ttiles.bin_pairs(tfp, cam, tcfg, BIN_CAP, geom=tgeom)
        culled = ttiles.bin_pairs(tfp, cam, tcfg.replace(**culls), BIN_CAP, geom=tgeom)
        assert all(torch.equal(a, b) for a, b in zip(plain[:5], culled[:5]))
        assert plain.order is None
        gauss = ttiles.bin_pairs(tfp, cam, tcfg.replace(pair_keys="gaussian"), BIN_CAP)
        nogeom = ttiles.bin_pairs(tfp, cam, tcfg, BIN_CAP)
        assert all(torch.equal(a, b) for a, b in zip(gauss, nogeom))
        with pytest.raises(ValueError, match="pair_keys"):
            ttiles.bin_pairs(tfp, cam, tcfg, BIN_CAP, geom=tgeom, tile_rows=(0, 8))
        band = ttiles.bin_pairs(tfp, cam, tcfg, BIN_CAP, tile_rows=(0, 8))
        assert band.order is not None
    scene = random_scene(600, seed=3)
    cam0 = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=32)
    cam1 = Camera.create(eye=(0.1, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=32)
    cfg = RenderConfig(hit_multiplicity=1, pair_keys=keys)
    base = cfg.replace(pair_keys="gaussian")
    rolled = render_rolling(scene, cam0, cam1, cfg, use_kernels=False)["rgb"]
    assert torch.equal(rolled, render_rolling(scene, cam0, cam1, base, use_kernels=False)["rgb"])
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    banded = render_pallas_sharded(scene, cam0, cfg, mesh)["rgb"]
    assert torch.equal(banded, render_pallas_sharded(scene, cam0, base, mesh)["rgb"])
    frame = render_gpu(scene, cam0, cfg, use_kernels=False)["rgb"]
    assert not torch.equal(frame, render_gpu(scene, cam0, base, use_kernels=False)["rgb"])


@functools.lru_cache(maxsize=None)
def _small_scene():
    js = j_random_scene(800, seed=5)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    return js, ts


def _stream_tiles(starts, gid) -> list:
    return [tuple(gid[a:b]) for a, b in zip(starts[:-1], starts[1:])]


def _sort_boundary_pixels(js, ts, jcfg: JConfig, tcfg: RenderConfig, cam: dict,
                          tiled: bool = False) -> np.ndarray:
    """(H, W) bool: the pixels of the tiles whose pair order differs
    between the packages' streams (JAX's prepare_pair_stream, the port's
    bin_frame; tiled: both prepare_frame's candidate lists, which XLA
    compiles apart, so its keys may round apart too), each over its own
    footprints and keys."""
    jc, tc = JCamera.create(**cam), Camera.create(**cam)
    if tiled:
        jb = jax.jit(jtiled.prepare_frame, static_argnums=(2, 3))(js, jc, jcfg, 65_536)[1]
        tiles_j = [tuple(row) for row in np.asarray(jb.cand)]
        tiles_t = [tuple(row) for row in ttiled.prepare_frame(ts, tc, tcfg, 65_536)[1].cand.numpy()]
    else:
        prep = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
        jstream = prep(js, jc, jcfg, 65_536, 128, False)[0]
        _, M, radius = ttiled.feature_table(ts, tcfg)
        tstream, _, _ = bin_frame(ts, M, radius, tc, tcfg, 65_536, use_kernels=False)
        tiles_j = _stream_tiles(np.asarray(jstream.starts), np.asarray(jstream.gid))
        tiles_t = _stream_tiles(tstream.starts.numpy(), tstream.gid.numpy())
    assert len(tiles_j) == len(tiles_t)
    off = np.array([a != b for a, b in zip(tiles_j, tiles_t)], np.float32)
    tx = -(-cam["width"] // tcfg.tile_w)
    grid = off.reshape(-1, tx)
    pix = np.kron(grid, np.ones((tcfg.tile_h, tcfg.tile_w), np.float32))
    return pix[: cam["height"], : cam["width"]] > 0


@pytest.mark.parametrize("order", ["window", "key"])
@pytest.mark.parametrize("keys", KEYS)
def test_render_matches_jax_render_pallas(keys, order):
    js, ts = _small_scene()
    kw = dict(hit_multiplicity=1, order=order, march_chunk=128 if order == "window" else 256,
              pair_keys=keys)
    ref = render_pallas(js, JCamera.create(**SMALL_CAM), JConfig(**kw), pair_capacity=65_536,
                        interpret=True, return_aux=True)
    out = render(ts, Camera.create(**SMALL_CAM), RenderConfig(**kw), method="plain",
                 pair_capacity=65_536, return_aux=True)
    assert out["aux"]["n_pairs"] == int(ref["aux"]["n_pairs"])
    assert out["aux"]["n_dropped"] == int(ref["aux"]["n_dropped"]) == 0
    skip = _sort_boundary_pixels(js, ts, JConfig(**kw), RenderConfig(**kw), SMALL_CAM)
    assert skip.mean() <= 2 / 24
    a, b = out["rgb"].numpy()[~skip], np.asarray(ref["rgb"])[~skip]
    ta, tb = out["alpha"].numpy()[~skip], np.asarray(ref["alpha"])[~skip]
    bar = 60.0 if order == "window" else 70.0
    assert psnr(a, b) >= bar and psnr(ta, tb) >= bar
    if order == "key":
        assert np.abs(a - b).max() <= 1e-2
    base = render(ts, Camera.create(**SMALL_CAM), RenderConfig(**{**kw, "pair_keys": "gaussian"}),
                  method="plain", pair_capacity=65_536)
    assert np.abs(base["rgb"].numpy() - out["rgb"].numpy()).max() > 1e-2  # the key matters


@pytest.mark.parametrize("keys", KEYS)
def test_render_tiled_matches_jax(keys, monkeypatch):
    js, ts = _small_scene()
    kw = dict(hit_multiplicity=1, max_per_tile=4096, order="window", pair_keys=keys)
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    want = jtiled.render_tiled(js, JCamera.create(**SMALL_CAM), jcfg, pair_capacity=65_536,
                               return_aux=True)
    rays = jax.jit(lambda c: j_generate_rays(c, jcfg))(JCamera.create(**SMALL_CAM))
    table = jax.jit(lambda s: jtiled.feature_table(s, jcfg))(js)
    monkeypatch.setattr(ttiled, "generate_rays", lambda cam, cfg: tuple(T(r) for r in rays))
    monkeypatch.setattr(ttiled, "feature_table", lambda scene, cfg: tuple(T(x) for x in table))
    got = ttiled.render_tiled(ts, Camera.create(**SMALL_CAM), tcfg, pair_capacity=65_536,
                              return_aux=True, xla_rounding=True)
    monkeypatch.undo()
    assert got["aux"] == {"n_pairs": int(want["aux"]["n_pairs"]), "n_dropped": 0}
    skip = _sort_boundary_pixels(js, ts, jcfg, tcfg, SMALL_CAM, tiled=True)
    keep = ~_boundary_rays(js, np.asarray(rays[1]), SMALL_CAM["eye"], 0.01) & ~skip
    assert keep.mean() > 0.9
    err = np.abs(got["rgb"].numpy() - np.asarray(want["rgb"]))[keep]
    assert (err > 2e-5).sum() <= 3 and err.max() <= 2e-3  # RGB_TAIL
    np.testing.assert_allclose(got["alpha"].numpy()[keep], np.asarray(want["alpha"])[keep],
                               atol=2e-5)


@pytest.mark.parametrize("order", ["key", "window"])
def test_tile_key_gradients_match_render_pallas_diff(order):
    """64x32, 500 gaussians of seed 1, pair_keys "tile": the JAX suite's
    training config (key order at chunk 256, window order at chunk 32),
    L2 to a flat target over every ray but the boundary rays and the
    sort-boundary tiles."""
    kw = dict(hit_multiplicity=1, order=order, max_per_tile=4096, chunk_skip_transmittance=1e-3,
              march_chunk=32 if order == "window" else 256, pair_keys="tile")
    cam_kw = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=32)
    jmodel = JGaussianModel.from_scene(j_random_scene(500, seed=1))
    js = jmodel.activate()
    port = GaussianModel.from_numpy({k: np.asarray(getattr(jmodel, k)) for k in FIELDS},
                                    jmodel.num_active).requires_grad_(True)
    cam, cfg = Camera.create(**cam_kw), RenderConfig(**kw)
    with torch.no_grad():
        ts = port.activate()
    boundary = _boundary_rays(js, generate_rays(cam, cfg)[1].numpy(), cam_kw["eye"],
                              cfg.alpha_min)
    skip = _sort_boundary_pixels(js, ts, JConfig(**kw), cfg, cam_kw)
    assert boundary.mean() <= 0.005 and skip.mean() <= 1 / 8
    keep = (~boundary & ~skip)[..., None].astype(np.float32)
    norm = 3.0 * keep.sum()
    target = np.full((32, 64, 3), 0.3, np.float32)

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(**cam_kw), JConfig(**kw),
                                 pair_capacity=100_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / norm

    j_loss, j_grads = jax.value_and_grad(loss_pallas)(jmodel)
    out = render_diff(port.activate(), cam, cfg, method="plain", pair_capacity=100_000)
    loss = torch.sum(T(keep) * (out["rgb"] - T(target)) ** 2) / norm
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    for f in FIELDS:
        a, b = getattr(port, f).grad.numpy(), np.asarray(getattr(j_grads, f))
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) <= 1e-3, f


# the JAX package's PSNR against its exact oracle (tiled march;
# scripts/key_quality.py on random_scene(3000, seed=0), 96x64)
JAX_PSNR = {("gaussian", "key"): 27.44, ("gaussian", "window"): 43.67,
            ("tile", "key"): 24.31, ("tile", "window"): 32.12,
            ("tile_peak", "key"): 21.93, ("tile_peak", "window"): 29.75,
            ("affine", "key"): 21.68, ("affine", "window"): 29.22}


@functools.lru_cache(maxsize=None)
def quality_frame():
    """random_scene(3000, seed=0) at 96x64 from (0, 0.3, 2.8) and its
    exact-oracle frame (hit_multiplicity 1)."""
    scene = random_scene(3000, seed=0)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    ref = render(scene, cam, RenderConfig(hit_multiplicity=1), method="oracle")["rgb"].numpy()
    return scene, cam, ref


def quality(method: str = "tiled", **kw) -> float:
    scene, cam, ref = quality_frame()
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, **kw)
    return psnr(render(scene, cam, cfg, method=method)["rgb"].numpy(), ref)


@pytest.mark.parametrize("keys,order", list(JAX_PSNR))
def test_quality_matches_jax(keys, order):
    assert abs(quality(pair_keys=keys, order=order) - JAX_PSNR[keys, order]) <= 0.1
