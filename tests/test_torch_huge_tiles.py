"""Tiles of more than 8192 rays (R = 8320, 16,384 and 65,536: 130x64,
128x128 and 256x256) in the port's plain path against the JAX package on
the CPU, where JAX takes any tile (a TPU any multiple of 128, with no upper
limit): the render in window, key, merge and oddeven order (`render_pallas`,
interpret mode) at R = 8320 and 16,384 and in key order at 65,536; training
in key and window order (`render_pallas_diff`) at 16,384; the
per-ray-origin quad `march_stream_diff` (`pallas_march_stream` /
`pallas_march_bwd`) at 16,384, and the origin centroid's halving tree at
65,536 summed as the cluster builds sum it; one mesh bounce frame (K4's
plain version and block mode, `render_with_mesh_fast`), the rolling shutter
(`render_rolling_pallas`) and the ray-band, shard-slice and tiled sharded
renderers of parallel/sharded.py against the port's single-device ones at
16,384; and the tiled march (`render_tiled`), which pads any tile as JAX's
does, at 12x12 (144 rays, which the kernel paths refuse) and 128x128.

Each frame is one tile or a few, at most 256x256, on at most 3000
gaussians. Bars, those of tests/test_torch_wider_tiles.py:
  - frames in window and merge order against render_pallas: >= 60 dB and
    an equal pair count; key and oddeven order >= 70 dB and max abs <=
    1e-2 (the quad-path bar);
  - training: the loss at rtol 1e-4, per raw field max|a - b| / max|b| <=
    1e-3, rgb >= 70 dB and max abs <= 1e-2, the boundary rays out of the
    loss (tests/test_torch_wide_tiles.py);
  - the per-ray-origin case: tests/test_torch_wide_tiles.py's forward tail
    bars, saved carries to 1e-4, gradients per column 1e-3 (2e-3 on M); the
    centroid bit for bit as origin_centroid's tree, and within 1e-6 of
    JAX's mean;
  - the mesh frame: >= 50 dB on rgb and alpha, equal block drops;
  - the rolling shutter >= 60 dB; the sharded frame bit for bit, its
    gradients at rtol 3e-5, atol 5e-7; the tiled sharded frame >= 55 dB
    and atol 2e-2 (tests/test_torch_parallel.py);
  - the tiled march with xla_rounding on JAX's rays and feature table: atol
    2e-5 off the boundary rays, and its own frame >= 70 dB
    (tests/test_torch_tiled.py)."""

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
from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JModel
from gaussian_ray_tracing_tpu.models.pallas_renderer import (
    prepare_pair_stream, render_pallas, render_pallas_diff,
)
from gaussian_ray_tracing_tpu.models.rolling import render_rolling_pallas
from gaussian_ray_tracing_tpu.models.tiled import tile_rays as j_tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_bwd, pallas_march_stream
from gaussian_ray_tracing_tpu.scene import mesh as jmesh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import MeshType, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as ttracer
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import render_gpu, render_gpu_diff
from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
from gaussian_ray_tracing_tpu_torch.models.rolling import render_rolling
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.parallel import mesh as pmesh
from gaussian_ray_tracing_tpu_torch.parallel import sharded as S
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import TriangleMesh
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_wide_tiles import FWD_TAIL_ABS, FWD_TAIL_FRAC, _boundary_rays

torch.set_num_threads(1)
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "sh")
EYE = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0))
TILES = {8320: (130, 64), 16384: (128, 128), 65536: (256, 256)}
T = lambda x: torch.from_numpy(np.array(x))


def _frame(rays):
    """A camera whose frame is one tile of `rays` rays."""
    tw, th = TILES[rays]
    return dict(EYE, width=tw, height=th)


@pytest.fixture(scope="module")
def scene300():
    js = j_random_scene(300, seed=5)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    return js, ts


@pytest.mark.parametrize("order,rays", [
    ("window", 8320), ("key", 8320), ("merge", 8320), ("oddeven", 8320), ("window", 16384),
    ("key", 16384), ("merge", 16384), ("oddeven", 16384), ("key", 65536)])
def test_huge_tile_render_matches_render_pallas(scene300, order, rays):
    """render(method="plain") on one tile of more than 8192 rays against
    render_pallas on the same tile (random_scene(300, seed=5), chunk 128):
    every tile-wide decision (the chunk skip, the window fire and key range,
    merge's fast test) spans the R rays on both sides."""
    js, ts = scene300
    tw, th = TILES[rays]
    cam = _frame(rays)
    kw = dict(hit_multiplicity=1, order=order, march_chunk=128, tile_w=tw, tile_h=th)
    ref = render_pallas(js, JCamera.create(**cam), JConfig(**kw), pair_capacity=100_000,
                        interpret=True, return_aux=True)
    out = render(ts, Camera.create(**cam), RenderConfig(**kw), method="plain",
                 pair_capacity=100_000, return_aux=True)
    assert out["aux"]["n_dropped"] == int(ref["aux"]["n_dropped"]) == 0
    a, b = out["rgb"].numpy(), np.asarray(ref["rgb"])
    assert float(out["alpha"].max()) > 0.5
    if order in ("window", "merge"):
        assert out["aux"]["n_pairs"] == int(ref["aux"]["n_pairs"])
        assert psnr(a, b) >= 60.0
        assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60.0
    else:
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
        assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 70.0


@pytest.mark.parametrize("order", ["key", "window"])
def test_huge_tile_training_matches_render_pallas_diff(order):
    """render_diff's value and gradient on one 128x128 tile (R = 16,384)
    against render_pallas_diff's (random_scene(300, seed=3), L2 to a flat
    target, the JAX suite's training config)."""
    cam = _frame(16384)
    kw = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3,
              order=order, tile_w=128, tile_h=128, march_chunk=32 if order == "window" else 256)
    jmodel = JModel.from_scene(j_random_scene(300, seed=3))
    dirs = generate_rays(Camera.create(**cam), RenderConfig())[1].numpy()
    keep = ~_boundary_rays(jmodel.activate(), np.array(EYE["eye"]), dirs, 0.01)
    assert keep.sum() >= 0.995 * keep.size
    keep = keep[..., None].astype(np.float32)
    target = np.full((cam["height"], cam["width"], 3), 0.3, np.float32)
    norm = 3.0 * keep.sum()

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(**cam), JConfig(**kw),
                                 pair_capacity=50_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / norm, out["rgb"]

    (j_loss, j_rgb), j_grads = jax.value_and_grad(loss_pallas, has_aux=True)(jmodel)
    model = GaussianModel.from_numpy({k: np.asarray(getattr(jmodel, k)) for k in FIELDS},
                                     jmodel.num_active).requires_grad_(True)
    out = render_diff(model.activate(), Camera.create(**cam), RenderConfig(**kw),
                      method="plain", pair_capacity=50_000)
    rgb = out["rgb"].detach().numpy()
    assert psnr(rgb * keep, np.asarray(j_rgb) * keep) >= 70.0
    assert np.abs(rgb - np.asarray(j_rgb)).max(axis=-1)[keep[..., 0] > 0].max() <= 1e-2
    assert float(out["alpha"].max()) > 0.5
    loss = torch.sum(torch.from_numpy(keep) * (out["rgb"] - torch.from_numpy(target)) ** 2) / norm
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    for f in FIELDS:
        a = getattr(model, f).grad.numpy()
        b = np.asarray(getattr(j_grads, f))
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) <= 1e-3, f


def test_per_ray_origin_quad_training_at_16384_rays_matches_jax():
    """march_stream_diff with per-ray origins, windows and carry-in on the
    quad response in key order, one 16,384-ray tile (128x128) over
    tests/test_torch_wider_tiles.py's 128x32 frame (random_scene(300,
    seed=6), chunk 32; the tile's other 12,288 rays dead, each with its
    origin in the centroid): forward, saved carries and d(pair_feats)
    against JAX's kernels. The forward tail bars measure the frame (on a
    128x128 frame of this scene they part at every tiling, 16x16 too: XLA's
    FMAs in the quad expansion)."""
    C = 32
    kw = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3,
              march_chunk=C, min_transmittance=1e-8, order="key", tile_w=128, tile_h=128)
    scene = j_random_scene(300, seed=6)
    cam = JCamera.create(**EYE, width=128, height=32)
    jcfg = JConfig(**kw)
    stream, pair_feats, _, _ = prepare_pair_stream(scene, cam, jcfg, 50_000, C)
    dirs_t = np.array(j_tile_rays(j_generate_rays(cam, jcfg)[1], 128, 128))
    Tn, R = dirs_t.shape[:2]
    assert R == 16384
    rng = np.random.default_rng(3)
    f32 = lambda x: np.asarray(x, np.float32)
    eye = np.array(cam.eye, np.float32)
    ext = dict(origins_t=f32(eye + 0.05 * rng.normal(size=(Tn, R, 3))),
               t_lo=f32(0.05 + 0.05 * rng.uniform(size=(Tn, R))),
               t_hi=f32(3.0 + rng.uniform(size=(Tn, R))),
               t0=f32(0.6 + 0.4 * rng.uniform(size=(Tn, R))))
    live = (dirs_t * dirs_t).sum(-1) > 0.01  # the frame's 4096 rays
    assert live.sum() == 128 * 32
    keep = ~_boundary_rays(scene, ext["origins_t"], dirs_t, jcfg.alpha_min) & live
    assert keep.sum() >= 0.99 * live.sum()
    d_rgb = f32(rng.normal(size=(Tn, R, 3)) * keep[..., None])
    d_tfinal = f32(rng.normal(size=(Tn, R)) * keep)
    starts, feats = np.array(stream.starts), np.array(pair_feats)

    j_rgb, j_t, j_tin, j_base = pallas_march_stream(
        starts, eye, feats, dirs_t, jcfg, n_tiles=Tn, rays_per_tile=R, chunk=C, interpret=True,
        save_tin=True, quad=True, **ext)
    j_dfeats = np.asarray(pallas_march_bwd(
        starts, eye, feats, dirs_t, j_tin, j_base, d_rgb, d_tfinal, jcfg, n_tiles=Tn,
        rays_per_tile=R, chunk=C, interpret=True, origins_t=ext["origins_t"],
        t_lo=ext["t_lo"], t_hi=ext["t_hi"]))

    cfg = RenderConfig(**kw)
    text = {k: T(v) for k, v in ext.items()}
    rows = tmarch.train_features(T(feats))
    rgb, t_final, tin, base = tmarch.march(T(starts), rows, T(dirs_t), cfg, C, save_tin=True,
                                           quad=True, **text)
    for a, b in ((rgb, j_rgb), (t_final, j_t)):
        err = np.abs(a.numpy() - np.asarray(b))[keep]
        assert (err > 2e-5).mean() <= FWD_TAIL_FRAC and err.max() <= FWD_TAIL_ABS
    assert np.array_equal(base.numpy(), np.asarray(j_base))
    n = int(base[-1])
    row_keep = keep[np.repeat(np.arange(Tn), np.diff(np.asarray(j_base)))]
    assert np.abs(tin.numpy() - np.asarray(j_tin)[:n, 3, :])[row_keep].max() <= 1e-4
    assert float(t_final.min()) < 0.5

    x = T(feats).requires_grad_(True)
    rgb2, t2 = tbwd.march_stream_diff(tmarch.train_features(x), T(starts), T(dirs_t), T(eye),
                                      cfg, C, use_kernels=False, quad=True, **text)
    (torch.sum(rgb2 * T(d_rgb)) + torch.sum(t2 * T(d_tfinal))).backward()
    got = x.grad.numpy()
    assert np.isfinite(got).all()
    for c in sorted(tmarch.diff_columns(0)):
        bar = 2e-3 if c in range(3, 12) else 1e-3  # the M columns cancel in float32
        assert np.abs(got[:, c] - j_dfeats[:, c]).max() <= bar * np.abs(j_dfeats[:, c]).max(), c


def _folded_tree(x: np.ndarray, max_values: int = 4096) -> np.ndarray:
    """The halving tree over x (float32, one tile's R values) summed as the
    cluster builds sum it (csrc/march.cuh origin_centroid_tile): its first
    levels folded as the values are read, value i of level l the sum of
    value i and i + n_l of level l - 1 (halving_value), down to at most
    max_values values, the rest level by level; then divided by R."""
    R = x.shape[0]
    n = [R, (R + 1) // 2]
    while n[-1] > max_values:
        n.append((n[-1] + 1) // 2)

    def value(level, i):
        if level == 0:
            return x[i]
        a = value(level - 1, i)
        return a + value(level - 1, i + n[level]) if i < n[level - 1] - n[level] else a

    h = n[-1]
    s = np.array([value(len(n) - 1, i) for i in range(h)], np.float32)
    while h > 1:
        h2 = (h + 1) // 2
        s = np.concatenate([s[: h - h2] + s[h2:h], s[h - h2 : h2]])
        h = h2
    return s[:1] / np.float32(R)


def test_origin_centroid_at_65536_rays():
    """The per-ray-origin quad response's centroid of a 65,536-ray tile:
    the cluster builds fold its first levels as they read the origins (no
    block holds 3 x 32,768 floats), which must be origin_centroid's tree
    bit for bit; and within 1e-6 of JAX's mean (pallas_march.py:398)."""
    rng = np.random.default_rng(11)
    origins = (np.array([0.3, -0.2, 2.6]) + 0.05 * rng.normal(size=(2, 65536, 3))).astype(
        np.float32)
    for t in range(2):
        for c in range(3):
            x = origins[t, :, c]
            tree = tmarch.origin_centroid(T(x)[None])[0].numpy()
            assert np.array_equal(_folded_tree(x), tree), (t, c)
            assert abs(float(tree[0]) - float(jnp.mean(jnp.asarray(x)))) <= 1e-6


def test_mesh_bounce_frame_at_16384_rays_matches_jax():
    """The JAX suite's TestMeshFast setup (the plane at z = 1.2 as GLASS,
    loop_bound 2) on random_scene(250, seed=4) at 64x64 on one 128x128 tile
    (R = 16,384, the rest of the tile dead rays): K4's plain version and
    the block march against render_with_mesh_fast."""
    js = j_random_scene(250, seed=4)
    cam = dict(EYE, width=64, height=64)
    kw = dict(hit_multiplicity=1, march_chunk=256, max_per_tile=4096,
              chunk_skip_transmittance=1e-3, tile_w=128, tile_h=128)
    jm = jmesh.make_plane(np.array([0.0, 0.0, 1.2], np.float32))
    want = jtracer.render_with_mesh_fast(js, jm, JCamera.create(**cam),
                                         JConfig(mesh_type=JMeshType.GLASS, **kw), loop_bound=2,
                                         interpret=True)
    tm = TriangleMesh.from_numpy({k: np.asarray(getattr(jm, k)) for k in
                                  ("vertices", "normals", "faces", "transform")}, jm.num_faces)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    record = []
    got = ttracer.render_with_mesh_fast(ts, tm, Camera.create(**cam),
                                        RenderConfig(mesh_type=MeshType.GLASS, **kw),
                                        loop_bound=2, use_kernels=False, record=record)
    for k in ("rgb", "alpha"):
        assert psnr(got[k].numpy(), np.asarray(want[k])) >= 50.0, k
    assert got["aux"]["block_dropped"] == int(want["aux"]["block_dropped"])
    assert float(got["alpha"].max()) > 0.5
    assert len(record) >= 2 and all(r["k4"][0][3].shape[1] == 16384 for r in record)


def test_rolling_shutter_at_16384_rays_matches_jax():
    """render_rolling on one 128x128 tile (per-ray origins, the scalar
    response) against render_rolling_pallas at the same tile (the eye
    moving 0.05 in x, random_scene(800, seed=2), key order): >= 60 dB."""
    js = j_random_scene(800, seed=2)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    pose0 = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=128, height=128)
    pose1 = dict(pose0, eye=(0.05, 0.3, 2.8))
    kw = dict(hit_multiplicity=1, order="key", march_chunk=128, tile_w=128, tile_h=128)
    ref = render_rolling_pallas(js, JCamera.create(**pose0), JCamera.create(**pose1),
                                JConfig(**kw))
    out = render_rolling(ts, Camera.create(**pose0), Camera.create(**pose1), RenderConfig(**kw),
                         return_aux=True, use_kernels=False)
    assert out["aux"]["n_dropped"] == 0
    assert psnr(out["rgb"].numpy(), np.asarray(ref["rgb"])) >= 60.0
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60.0
    assert float(out["rgb"].max()) > 0.1


@pytest.mark.parametrize("order", ["key", "window"])
def test_sharded_renderers_at_16384_rays_match_single_device(order):
    """The ray-band forward and the shard-slice gradients of
    parallel/sharded.py on 128x128 tiles, 8 CPU shards: the frame bit for
    bit as render_gpu's, the gradients at tests/test_torch_parallel.py's
    bars (rtol 3e-5, atol 5e-7) against render_gpu_diff's; and (key order)
    the tiled sharded frame against render_tiled's."""
    mesh = pmesh.make_mesh(8, devices=[torch.device("cpu")] * 8)
    cfg = RenderConfig(hit_multiplicity=1, order=order, tile_w=128, tile_h=128)
    scene = random_scene(500, seed=3)
    cam = Camera.create(**EYE, width=128, height=256)  # two bands of one tile
    a = render_gpu(scene, cam, cfg, use_kernels=False)
    b = S.render_pallas_sharded(scene, cam, cfg, mesh)
    assert b["n_dropped"] == 0
    assert torch.equal(a["rgb"], b["rgb"]) and torch.equal(a["alpha"], b["alpha"])
    small = Camera.create(**EYE, width=128, height=128)
    if order == "key":
        ref = ttiled.render_tiled(scene, small, cfg)
        out = S.render_tiled_sharded(scene, small, cfg, mesh)
        assert psnr(ref["rgb"].numpy(), out["rgb"].numpy()) > 55.0
        np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"].numpy(), atol=2e-2)
    model = GaussianModel.from_scene(random_scene(400, seed=6)).requires_grad_(True)
    target = torch.full((128, 128, 3), 0.3)
    grads = []
    for fn in (lambda s: S.render_pallas_sharded_diff(s, small, cfg, mesh, pair_capacity=100_000),
               lambda s: render_gpu_diff(s, small, cfg, pair_capacity=100_000,
                                         use_kernels=False)):
        for p in model.parameters():
            p.grad = None
        torch.mean((fn(model.activate())["rgb"] - target) ** 2).backward()
        grads.append({f: getattr(model, f).grad.clone() for f in FIELDS})
    for f in FIELDS:
        assert float(grads[1][f].abs().max()) > 0.0, f
        np.testing.assert_allclose(grads[0][f].numpy(), grads[1][f].numpy(), rtol=3e-5,
                                   atol=5e-7, err_msg=f)


@pytest.mark.parametrize("tile", [(12, 12), (128, 128)])
def test_tiled_march_takes_every_tile_jax_takes(scene300, monkeypatch, tile):
    """render_tiled on 12x12 tiles (144 rays: no multiple of 32, which the
    kernel paths refuse as a TPU does) and on one 128x128 tile against JAX's
    render_tiled (on JAX's rays and feature table, xla_rounding), and its
    own frame; render(method="tiled"), render_diff(method="tiled") and
    Trainer(method="tiled") take the tile too."""
    from gaussian_ray_tracing_tpu_torch.train.trainer import Trainer

    js, ts = scene300
    tw, th = tile
    cam = dict(EYE, width=96, height=64) if tile == (12, 12) else _frame(16384)
    kw = dict(hit_multiplicity=1, max_per_tile=4096, order="key", tile_w=tw, tile_h=th)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    want = jtiled.render_tiled(js, JCamera.create(**cam), jcfg, pair_capacity=100_000,
                               return_aux=True)
    rays = jax.jit(lambda c: j_generate_rays(c, jcfg))(JCamera.create(**cam))
    table = jax.jit(lambda s: jtiled.feature_table(s, jcfg))(js)
    own = render(ts, Camera.create(**cam), cfg, method="tiled", pair_capacity=100_000)
    diff = render_diff(GaussianModel.from_scene(ts).activate(), Camera.create(**cam), cfg,
                       method="tiled", pair_capacity=100_000)
    with monkeypatch.context() as m:
        m.setattr(ttiled, "generate_rays", lambda c, config: tuple(T(r) for r in rays))
        m.setattr(ttiled, "feature_table", lambda scene, config: tuple(T(x) for x in table))
        got = ttiled.render_tiled(ts, Camera.create(**cam), cfg, pair_capacity=100_000,
                                  return_aux=True, xla_rounding=True)
    assert got["aux"] == {"n_pairs": int(want["aux"]["n_pairs"]), "n_dropped": 0}
    keep = ~_boundary_rays(js, cam["eye"], np.asarray(rays[1]), 0.01)
    assert keep.mean() > 0.99
    b = np.asarray(want["rgb"])
    np.testing.assert_allclose(got["rgb"].numpy()[keep], b[keep], atol=2e-5)
    np.testing.assert_allclose(got["alpha"].numpy()[keep], np.asarray(want["alpha"])[keep],
                               atol=2e-5)
    for a in (own["rgb"].numpy(), diff["rgb"].detach().numpy()):
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    view = (Camera.create(**cam), torch.full((cam["height"], cam["width"], 3), 0.3))
    trainer = Trainer(GaussianModel.from_scene(random_scene(300, seed=3)), config=cfg, lr=2e-3,
                      method="tiled")
    losses = trainer.fit([view], steps=1)
    assert all(np.isfinite(losses))


def test_scratch_tiles_bound_a_launch():
    """A launch of several rays a thread holds at most SCRATCH_BYTES of
    scratch, or one tile's where one tile needs more: merge order's carry at
    chunk 256 and 65,536 rays (781 floats a ray) runs 20 tiles a launch,
    so that an 8K frame's 2040 such tiles fit on any card that holds 20."""
    from gaussian_ray_tracing_tpu_torch.ops.march import SCRATCH_BYTES, scratch_tiles

    tile = 4 * 781 * 65536
    assert scratch_tiles(tile, 15) == 15
    assert scratch_tiles(tile, 2040) == SCRATCH_BYTES // tile == 20
    assert scratch_tiles(SCRATCH_BYTES + 1, 7) == 1
    assert scratch_tiles(1, 3) == 3
