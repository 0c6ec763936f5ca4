"""Tiles of more than 1024 rays (R = 1152, 2048 and 4096: 48x24, 64x32 and
64x64) in the port's plain path against the JAX package on the CPU, where
JAX takes any tile (a TPU any multiple of 128): the render in window, key,
merge and oddeven order (`render_pallas`, interpret mode), window order at
R = 2048 with and without sort_lane_groups (`pallas_march_stream` with
stats on one JAX pair stream),
training in key and window order (`render_pallas_diff`), the per-ray-origin
quad `march_stream_diff` (`pallas_march_stream` / `pallas_march_bwd`), one
mesh bounce frame (K4's plain version and block mode,
`render_with_mesh_fast`), the rolling shutter (`render_rolling_pallas`)
and the tiled march (`render_tiled`); the ray-band and shard-slice
renderers of parallel/sharded.py against the port's single-device ones;
and the config's limit: every multiple of 128 above 1024 rays, with no
upper limit (tests/test_torch_huge_tiles.py holds the tiles above 8192).

Bars, those of tests/test_torch_wide_tiles.py and the files it cites:
  - frames in window and merge order against render_pallas: >= 60 dB and
    an equal pair count (tests/test_torch_render.py: the port bins its own
    footprints); key and oddeven order >= 70 dB and max abs <= 1e-2 (the
    quad-path bar);
  - window order on JAX's own stream: >= 70 dB and max abs <= 1e-2, and
    the per-tile fired and repaired counts equal (tests/test_torch_window_
    options.py), leaving out the sort-boundary rays it defines (their
    count stated);
  - training: the loss at rtol 1e-4, per raw field max|a - b| / max|b| <=
    1e-3, rgb >= 70 dB and max abs <= 1e-2, the boundary rays out of the
    loss (tests/test_torch_wide_tiles.py);
  - the per-ray-origin case: tests/test_torch_wide_tiles.py's forward tail
    bars, saved carries to 1e-4, gradients per column 1e-3 (2e-3 on M);
  - the mesh frame: >= 50 dB on rgb and alpha, equal block drops
    (tests/test_torch_mesh_render.py);
  - the tiled march with xla_rounding on JAX's rays and feature table: atol
    2e-5 off the boundary rays, and its own frame >= 70 dB
    (tests/test_torch_tiled.py);
  - the rolling shutter >= 60 dB (tests/test_torch_rolling.py); the
    sharded frame bit for bit, its gradients at rtol 3e-5, atol 5e-7
    (tests/test_torch_parallel.py)."""

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
from gaussian_ray_tracing_tpu_torch import config as tcfg
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
from gaussian_ray_tracing_tpu_torch.ops import tri as ttri
from gaussian_ray_tracing_tpu_torch.parallel import mesh as pmesh
from gaussian_ray_tracing_tpu_torch.parallel import sharded as S
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import TriangleMesh
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_wide_tiles import FWD_TAIL_ABS, FWD_TAIL_FRAC, _boundary_rays
import test_torch_window_options
from test_torch_window_options import _sort_boundary_rays

torch.set_num_threads(1)
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "sh")
EYE = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0))
CAM = dict(EYE, width=96, height=64)
SMALL = dict(EYE, width=64, height=64)  # two 64x32 tiles
ONE = dict(EYE, width=64, height=32)
TILES = {1152: (48, 24), 2048: (64, 32), 4096: (64, 64)}
T = lambda x: torch.from_numpy(np.array(x))
WC = 64  # the window march's chunk



@pytest.fixture(scope="module")
def scene2000():
    js = j_random_scene(2000, seed=5)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    return js, ts


def test_config_takes_tiles_up_to_8192_rays():
    """Every multiple of 128 rays above 1024 renders, trains and traces
    meshes (from 1152 to 8192 one ray a thread, above several; no upper
    limit, as on a TPU); 1056 rays (32x33, not a multiple of 128) and 144
    (12x12) are refused on the kernel paths with the reason, and the tiled
    march, which pads any tile, takes both."""
    for rays in [*range(1152, 8193, 128), 8320, 16384, 24576, 65536, 262144]:
        cfg = RenderConfig(tile_w=rays // 32, tile_h=32)
        assert tcfg.unsupported_fields(cfg) == [], rays
        assert tcfg.unsupported_train_fields(cfg) == []
        assert tcfg.unsupported_mesh_fields(cfg) == []
        assert tcfg.unsupported_tiled_fields(cfg) == []
    for tw, th in ((32, 33), (12, 12)):
        cfg = RenderConfig(tile_w=tw, tile_h=th)
        for bad in (tcfg.unsupported_fields(cfg), tcfg.unsupported_train_fields(cfg),
                    tcfg.unsupported_mesh_fields(cfg)):
            assert len(bad) == 1 and "a multiple of 32 up to 1024 or of 128 above" in bad[0]
        with pytest.raises(NotImplementedError, match="of 128 above"):
            tcfg.check_supported(cfg)
        assert tcfg.unsupported_tiled_fields(cfg) == []


@pytest.mark.parametrize("order,rays", [("window", 1152), ("key", 4096), ("merge", 4096),
                                        ("oddeven", 1152)])
def test_wider_tile_render_matches_render_pallas(scene2000, order, rays):
    """render(method="plain") on tiles of more than 1024 rays against
    render_pallas at the same tiles (96x64, random_scene(2000, seed=5),
    chunk 128): every tile-wide decision (the chunk skip, the window fire
    and key range, merge's fast test) spans R rays on both sides."""
    js, ts = scene2000
    tw, th = TILES[rays]
    kw = dict(hit_multiplicity=1, order=order, march_chunk=128, tile_w=tw, tile_h=th)
    ref = render_pallas(js, JCamera.create(**CAM), JConfig(**kw), pair_capacity=200_000,
                        interpret=True, return_aux=True)
    out = render(ts, Camera.create(**CAM), RenderConfig(**kw), method="plain",
                 pair_capacity=200_000, return_aux=True)
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


@pytest.fixture(scope="module")
def stream2048():
    """One JAX pair stream on 64x32 tiles (64x64, random_scene(800,
    seed=5), chunk 64) as numpy arrays."""
    scene = j_random_scene(800, seed=5)
    cam = JCamera.create(**SMALL)
    jcfg = JConfig(hit_multiplicity=1, march_chunk=WC, tile_w=64, tile_h=32)
    stream, pair_feats, _, _ = prepare_pair_stream(scene, cam, jcfg, 65_536, WC, False)
    return dict(starts=np.array(stream.starts), eye=np.array(cam.eye),
                pair_feats=np.array(pair_feats),
                dirs_t=np.array(j_tile_rays(j_generate_rays(cam, jcfg)[1], 64, 32)))


@pytest.mark.parametrize("kw,edges", [({}, 6), (dict(sort_lane_groups=True), 2)])
def test_window_march_at_2048_rays_matches_pallas(stream2048, monkeypatch, kw, edges):
    """Window order on 64x32 tiles, the whole tile one fire group or (with
    sort_lane_groups) 16 groups of 128 rays, the chunk skip tile-wide, on
    JAX's own pair stream against pallas_march_stream with stats: the image
    at the bars off the sort-boundary rays (tests/test_torch_window_
    options.py; their count stated per case), the per-tile fired and
    repaired chunks equal. (A whole frame through render() parts on those
    rays too: 53.4 dB on random_scene(2000, seed=5) at 96x64, where the two
    packages' streams march alike.)"""
    inp = stream2048
    Tn, R = inp["dirs_t"].shape[:2]
    assert R == 2048
    jcfg = JConfig(hit_multiplicity=1, march_chunk=WC, **kw)
    want = pallas_march_stream(inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], jcfg,
                               n_tiles=Tn, rays_per_tile=R, chunk=WC, interpret=True, quad=True,
                               packed16=False, stats=True)
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=WC, **kw)
    assert tmarch.window_options(cfg, R, WC, False)["group"] == (128 if kw else R)
    rgb, t_final, stats = tmarch.march(T(inp["starts"]), tmarch.compact_features(
        T(inp["pair_feats"])), T(inp["dirs_t"]), cfg, WC, stats=True)
    # _sort_boundary_rays at this chunk
    monkeypatch.setattr(test_torch_window_options, "C", WC)
    monkeypatch.setattr(test_torch_window_options, "KW", dict(hit_multiplicity=1, march_chunk=WC))
    edge = _sort_boundary_rays(inp, kw)
    assert int(edge.sum()) == edges  # a few rays, never a region
    for a, b in ((rgb, want[0]), (t_final, want[1])):
        a, b = a.numpy()[~edge], np.asarray(b)[~edge]
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    for a, b in zip(stats, want[2]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(stats[0].sum()) > 0


@pytest.mark.parametrize("order", ["key", "window"])
def test_wider_tile_training_matches_render_pallas_diff(order):
    """render_diff's value and gradient on 64x32 tiles (R = 2048) against
    render_pallas_diff's (128x64, random_scene(300, seed=3), L2 to a flat
    target, the JAX suite's training config)."""
    kw = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3,
              order=order, tile_w=64, tile_h=32, march_chunk=32 if order == "window" else 256)
    jmodel = JModel.from_scene(j_random_scene(300, seed=3))
    dirs = generate_rays(Camera.create(**CAM), RenderConfig())[1].numpy()
    keep = ~_boundary_rays(jmodel.activate(), np.array(EYE["eye"]), dirs, 0.01)
    assert keep.sum() >= 0.995 * keep.size
    keep = keep[..., None].astype(np.float32)
    target = np.full((CAM["height"], CAM["width"], 3), 0.3, np.float32)
    norm = 3.0 * keep.sum()

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(**CAM), JConfig(**kw),
                                 pair_capacity=100_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / norm, out["rgb"]

    (j_loss, j_rgb), j_grads = jax.value_and_grad(loss_pallas, has_aux=True)(jmodel)
    model = GaussianModel.from_numpy({k: np.asarray(getattr(jmodel, k)) for k in FIELDS},
                                     jmodel.num_active).requires_grad_(True)
    out = render_diff(model.activate(), Camera.create(**CAM), RenderConfig(**kw),
                      method="plain", pair_capacity=100_000)
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


def test_per_ray_origin_quad_training_at_2048_rays_matches_jax():
    """march_stream_diff with per-ray origins, windows and carry-in on the
    quad response in key order, two 2048-ray tiles (128x32, 64x32 tiles,
    random_scene(300, seed=6), chunk 32): forward, saved carries and
    d(pair_feats) against JAX's kernels. The centroid's halving tree pairs
    ray i with ray i + 1024 first, which a cluster's blocks split."""
    C = 32
    kw = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3,
              march_chunk=C, min_transmittance=1e-8, order="key", tile_w=64, tile_h=32)
    scene = j_random_scene(300, seed=6)
    cam = JCamera.create(**EYE, width=128, height=32)
    jcfg = JConfig(**kw)
    stream, pair_feats, _, _ = prepare_pair_stream(scene, cam, jcfg, 50_000, C)
    dirs_t = np.array(j_tile_rays(j_generate_rays(cam, jcfg)[1], 64, 32))
    Tn, R = dirs_t.shape[:2]
    assert R == 2048
    rng = np.random.default_rng(3)
    f32 = lambda x: np.asarray(x, np.float32)
    eye = np.array(cam.eye, np.float32)
    ext = dict(origins_t=f32(eye + 0.05 * rng.normal(size=(Tn, R, 3))),
               t_lo=f32(0.05 + 0.05 * rng.uniform(size=(Tn, R))),
               t_hi=f32(3.0 + rng.uniform(size=(Tn, R))),
               t0=f32(0.6 + 0.4 * rng.uniform(size=(Tn, R))))
    keep = ~_boundary_rays(scene, ext["origins_t"], dirs_t, jcfg.alpha_min)
    assert keep.sum() >= 0.99 * keep.size
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


def test_mesh_bounce_frame_at_2048_rays_matches_jax():
    """The JAX suite's TestMeshFast setup (random_scene(1200, seed=4), the
    plane at z = 1.2 as GLASS, loop_bound 2) at 64x32 on one 64x32 tile: K4's
    plain version and the block march at R = 2048 against
    render_with_mesh_fast; and the pretests' counts of each bounce, as the
    kernel splits a tile (two blocks of 1024 rays), the sums of the two
    halves' counts as tiles of their own."""
    js = j_random_scene(1200, seed=4)
    kw = dict(hit_multiplicity=1, march_chunk=256, max_per_tile=4096,
              chunk_skip_transmittance=1e-3, tile_w=64, tile_h=32)
    jm = jmesh.make_plane(np.array([0.0, 0.0, 1.2], np.float32))
    want = jtracer.render_with_mesh_fast(js, jm, JCamera.create(**ONE),
                                         JConfig(mesh_type=JMeshType.GLASS, **kw), loop_bound=2,
                                         interpret=True)
    tm = TriangleMesh.from_numpy({k: np.asarray(getattr(jm, k)) for k in
                                  ("vertices", "normals", "faces", "transform")}, jm.num_faces)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    record = []
    got = ttracer.render_with_mesh_fast(ts, tm, Camera.create(**ONE),
                                        RenderConfig(mesh_type=MeshType.GLASS, **kw),
                                        loop_bound=2, use_kernels=False, record=record)
    for k in ("rgb", "alpha"):
        assert psnr(got[k].numpy(), np.asarray(want[k])) >= 50.0, k
    assert got["aux"]["block_dropped"] == int(want["aux"]["block_dropped"])
    assert float(got["alpha"].max()) > 0.5
    assert len(record) >= 2
    for rec in record:
        args, k4 = rec["k4"]
        starts, blocks, faces, dirs_t, eye = args[:5]
        assert dirs_t.shape[1] == 2048 and ttri.tile_splits(2048) == 2
        stats = ttri.pretest_stats(*args, k4["origins_t"], k4["bounds"])
        # each half a tile of its own, over its tile's block list listed twice
        half = lambda x: None if x is None else x.reshape(-1, 1024, 3)
        per_tile = (starts[1:] - starts[:-1]) // 256
        idx = torch.cat([torch.arange(int(a) // 256, int(a) // 256 + int(n))
                         for a, n in zip(starts[:-1], per_tile) for _ in range(2)])
        s2 = torch.cat([starts.new_zeros(1),
                        torch.cumsum(per_tile.repeat_interleave(2), 0).to(torch.int32) * 256])
        halves = ttri.pretest_stats(s2, blocks[idx], faces, half(dirs_t), eye, *args[5:7],
                                    half(k4["origins_t"]), k4["bounds"])
        assert torch.equal(stats, halves.reshape(-1, 2, len(ttri.STATS)).sum(1, dtype=torch.int32))
        hit = ttri.closest_hit_blocks_plain(*args, **k4)
        assert torch.equal(hit[1], ttri.closest_hit_blocks(*args, **k4)[1])


def test_tiled_march_at_2048_rays_matches_jax(scene2000, monkeypatch):
    """render_tiled on 64x32 tiles against JAX's (on JAX's rays and feature
    table, xla_rounding), and its own frame. Key order: in window order
    three values of this frame (0.012%) differ by up to 9.2e-4 at 16x16
    tiles as at 64x32, a near-tie of the per-ray sort under XLA's FMAs, not
    the tile size."""
    js, ts = scene2000
    kw = dict(hit_multiplicity=1, max_per_tile=4096, order="key", tile_w=64, tile_h=32)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    want = jtiled.render_tiled(js, JCamera.create(**CAM), jcfg, pair_capacity=200_000,
                               return_aux=True)
    rays = jax.jit(lambda c: j_generate_rays(c, jcfg))(JCamera.create(**CAM))
    table = jax.jit(lambda s: jtiled.feature_table(s, jcfg))(js)
    own = render(ts, Camera.create(**CAM), cfg, method="tiled", pair_capacity=200_000)
    monkeypatch.setattr(ttiled, "generate_rays", lambda cam, c: tuple(T(r) for r in rays))
    monkeypatch.setattr(ttiled, "feature_table", lambda scene, c: tuple(T(x) for x in table))
    got = ttiled.render_tiled(ts, Camera.create(**CAM), cfg, pair_capacity=200_000,
                              return_aux=True, xla_rounding=True)
    assert got["aux"] == {"n_pairs": int(want["aux"]["n_pairs"]), "n_dropped": 0}
    keep = ~_boundary_rays(js, CAM["eye"], np.asarray(rays[1]), 0.01)
    assert keep.mean() > 0.99
    b = np.asarray(want["rgb"])
    np.testing.assert_allclose(got["rgb"].numpy()[keep], b[keep], atol=2e-5)
    np.testing.assert_allclose(got["alpha"].numpy()[keep], np.asarray(want["alpha"])[keep],
                               atol=2e-5)
    a = own["rgb"].numpy()
    assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


def test_rolling_shutter_at_2048_rays_matches_jax():
    """render_rolling on 64x32 tiles (per-ray origins, the scalar response)
    against render_rolling_pallas at the same tiles (64x48, the eye moving
    0.05 in x, random_scene(800, seed=2), key order): >= 60 dB
    (tests/test_torch_rolling.py)."""
    js = j_random_scene(800, seed=2)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    pose0 = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=48)
    pose1 = dict(pose0, eye=(0.05, 0.3, 2.8))
    kw = dict(hit_multiplicity=1, order="key", march_chunk=128, tile_w=64, tile_h=32)
    ref = render_rolling_pallas(js, JCamera.create(**pose0), JCamera.create(**pose1),
                                JConfig(**kw))
    out = render_rolling(ts, Camera.create(**pose0), Camera.create(**pose1), RenderConfig(**kw),
                         return_aux=True, use_kernels=False)
    assert out["aux"]["n_dropped"] == 0
    assert psnr(out["rgb"].numpy(), np.asarray(ref["rgb"])) >= 60.0
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60.0
    assert float(out["rgb"].max()) > 0.1


@pytest.mark.parametrize("order", ["key", "window"])
def test_sharded_renderers_at_2048_rays_match_single_device(order):
    """The ray-band forward and the shard-slice gradients of
    parallel/sharded.py on 64x32 tiles, 8 CPU shards: the frame bit for
    bit as render_gpu's, the gradients at tests/test_torch_parallel.py's
    bars (rtol 3e-5, atol 5e-7) against render_gpu_diff's."""
    mesh = pmesh.make_mesh(8, devices=[torch.device("cpu")] * 8)
    cfg = RenderConfig(hit_multiplicity=1, order=order, tile_w=64, tile_h=32)
    scene = random_scene(2000, seed=3)
    cam = Camera.create(**EYE, width=128, height=96)
    a = render_gpu(scene, cam, cfg, use_kernels=False)
    b = S.render_pallas_sharded(scene, cam, cfg, mesh)
    assert b["n_dropped"] == 0
    assert torch.equal(a["rgb"], b["rgb"]) and torch.equal(a["alpha"], b["alpha"])
    model = GaussianModel.from_scene(random_scene(600, seed=6)).requires_grad_(True)
    small = Camera.create(**EYE, width=64, height=64)
    target = torch.full((64, 64, 3), 0.3)
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
