"""Key and oddeven order at every march chunk JAX takes, in the port against
the JAX package on the CPU (the plain versions of K1 and K3 against Pallas
in interpret mode).

JAX marches any chunk max(32, min(march_chunk, 256)) and, in block mode,
chunk * bounce_blocks_per_chunk rows, with no cap in key order
(models/pallas_renderer.py:136-138, 215-216; models/mesh_tracer.py:325-326,
447-453; ops/pallas_march.py:1106-1110). The chunk is part of the output:
the chunk skip, the saved carries and the per-chunk composite follow it.
Window and merge order at a chunk that is not a power of two are refused by
name before any march runs (JAX's bitonic network does not sort there); the
tiled march, a real per-ray argsort, takes them.

Bars and why:
  - render(method="plain") against render_pallas: the key-order K1 bar
    (>= 70 dB, max abs <= 1e-2, tests/test_torch_key_order.py's).
  - march_stream_diff against JAX's custom_vjp (from the eye, and from
    per-ray origins with windows and carry-in on the quad response):
    forward at the K1 bar, gradients per written column max|a - b| /
    max|b| <= 1e-3, the nine M columns 2e-3 (their reference algebra
    cancels in float32), every other column exactly 0
    (tests/test_torch_march_bwd.py's bars).
  - render_diff(method="plain") against render_pallas_diff in merge and key
    order (merge trains as key): per raw field 1e-3, the loss at rtol 1e-4,
    boundary rays out of the loss (tests/test_torch_train.py's bars).
  - the mesh tracer under bounce_order "key" against render_with_mesh_fast
    at 256 x 2 and 96 x 3 block-mode rows: >= 50 dB on rgb and alpha,
    equal block drops (tests/test_torch_mesh_render.py's bar).
  - the tiled march in window order at chunk 96 against JAX's on JAX's
    rays and table: atol 2e-5 (tests/test_torch_tiled.py's bar)."""

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
from gaussian_ray_tracing_tpu.models.pallas_renderer import (
    prepare_pair_stream, render_pallas, render_pallas_diff,
)
from gaussian_ray_tracing_tpu.ops.pallas_march import march_stream_diff as j_march_stream_diff
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_bwd, pallas_march_stream
from gaussian_ray_tracing_tpu.scene import mesh as jmesh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch import config as tcfg
from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import MeshType, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as ttracer
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS
from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import TriangleMesh
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_march import _boundary_rays as _tiled_boundary_rays
from test_torch_per_ray_origin import EXTRAS, _stream
from test_torch_train import JModel, _boundary_rays, _port_model

torch.set_num_threads(1)
T = lambda x: torch.from_numpy(np.array(x))
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "sh")
SMALL_CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
GRAD_REL, GRAD_REL_M = 1e-3, 2e-3


def _carry_scene(js) -> GaussianScene:
    return GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                    js.num_active)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


def _grads_close(got, want, columns, diff, m_cols):
    """Per written column at 1e-3 of max|b| (M columns 2e-3); every other
    column exactly zero."""
    for i, col in enumerate(columns):
        if col in diff:
            b = want[:, col]
            bar = GRAD_REL_M if col in m_cols else GRAD_REL
            assert np.abs(got[:, i] - b).max() <= bar * np.abs(b).max(), (i, col)
        else:
            assert not got[:, i].any(), (i, col)


@pytest.fixture(scope="module")
def scene2000():
    js = j_random_scene(2000, seed=0)
    return js, _carry_scene(js)


@pytest.mark.parametrize("order,chunk", [("key", 96), ("key", 100), ("oddeven", 100)])
def test_render_matches_jax_render_pallas(scene2000, order, chunk):
    """96x64, random_scene(2000, seed 0): the port's plain K1 at the chunk
    the config asks for against render_pallas in interpret mode; the frame
    at chunk 128 differs from it (the chunk is part of the output)."""
    js, ts = scene2000
    kw = dict(hit_multiplicity=1, order=order, march_chunk=chunk)
    ref = render_pallas(js, JCamera.create(**SMALL_CAM), JConfig(**kw), pair_capacity=65_536,
                        interpret=True, return_aux=True)
    out = render(ts, Camera.create(**SMALL_CAM), RenderConfig(**kw), method="plain",
                 pair_capacity=65_536, return_aux=True)
    assert out["aux"]["n_pairs"] == int(ref["aux"]["n_pairs"])
    assert out["aux"]["n_dropped"] == 0
    _close(out["rgb"].numpy(), ref["rgb"])
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 70.0
    at_128 = render(ts, Camera.create(**SMALL_CAM), RenderConfig(**{**kw, "march_chunk": 128}),
                    method="plain", pair_capacity=65_536)["rgb"]
    assert float((at_128 - out["rgb"]).abs().max()) > 1e-4


@pytest.mark.parametrize("chunk", [96, 40])
def test_march_stream_diff_matches_jax(chunk):
    """K1's saved carries and K3's key replay from the eye at a chunk that
    is not a power of two (64x48, 600 gaussians): the port's
    march_stream_diff (plain versions) against JAX's custom_vjp on one JAX
    stream, forward, carries and gradients."""
    scene = j_random_scene(600, seed=7)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=48)
    prep = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pf, _, _ = prep(scene, cam, JConfig(hit_multiplicity=1), 65_536, chunk, False)
    _, dirs, _ = j_generate_rays(cam, JConfig())
    dirs_t = np.array(jtiled.tile_rays(dirs, 16, 16))
    starts, pf, eye = np.array(stream.starts), np.array(pf), np.array(cam.eye, np.float32)
    counts = np.diff(starts)
    assert (counts % chunk).any() and (counts > 2 * chunk).any()  # ragged, several chunks
    T_, R = dirs_t.shape[:2]
    rng = np.random.default_rng(11)
    d_rgb = rng.normal(size=dirs_t.shape).astype(np.float32)
    d_t = rng.normal(size=(T_, R)).astype(np.float32)
    kw = dict(hit_multiplicity=1, order="key", march_chunk=chunk)
    cfg = RenderConfig(**kw)
    rows = tmarch.train_features(T(pf)).requires_grad_(True)
    rgb, t_final = tbwd.march_stream_diff(rows, T(starts), T(dirs_t), T(eye), cfg, chunk,
                                          use_kernels=False)
    (torch.sum(rgb * T(d_rgb)) + torch.sum(t_final * T(d_t))).backward()
    out, vjp = jax.vjp(lambda f: j_march_stream_diff(starts, jnp.asarray(eye), f, dirs_t,
                                                      JConfig(**kw), T_, R, chunk, True),
                       jnp.asarray(pf))
    (j_grad,) = vjp((jnp.asarray(d_rgb), jnp.asarray(d_t)))
    for a, b in zip((rgb.detach(), t_final.detach()), out):
        _close(a.numpy(), b)
    _grads_close(rows.grad.numpy(), np.asarray(j_grad), tmarch.TRAIN_COLUMNS,
                 tmarch.diff_columns(0), range(3, 12))
    # the saved carries: one row per chunk of `chunk` candidates
    _, _, tin, base = tmarch.march(T(starts), rows.detach(), T(dirs_t), cfg, chunk,
                                   save_tin=True)
    assert np.array_equal(base.numpy()[1:], np.cumsum(-(-counts // chunk)))
    _, _, j_tin, j_base = pallas_march_stream(starts, eye, pf, dirs_t, JConfig(**kw),
                                              n_tiles=T_, rays_per_tile=R, chunk=chunk,
                                              interpret=True, save_tin=True)
    assert np.array_equal(base.numpy(), np.asarray(j_base))
    n = int(np.asarray(j_base)[-1])
    assert float(np.abs(tin.numpy() - np.asarray(j_tin)[:n, 3, :]).max()) <= 1e-4


def test_origin_quad_training_matches_jax():
    """K1's saved carries on the per-ray-origin quad response and K3's
    replay from per-ray origins, windows and carry-in (quad=True) at chunk
    96: tests/test_torch_per_ray_origin.py's stream (32x16, random_scene(300,
    seed 6), boundary rays out of the cotangent) against JAX's
    pallas_march_stream(save_tin=True, quad=True) and pallas_march_bwd."""
    c = 96
    inp = _stream(0)
    kw = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3,
              march_chunk=c, min_transmittance=1e-8, order="key")
    T_, R = inp["dirs_t"].shape[:2]
    ext = {k: inp[k] for k in EXTRAS}
    j_rgb, j_t, j_tin, j_base = pallas_march_stream(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], JConfig(**kw), n_tiles=T_,
        rays_per_tile=R, chunk=c, interpret=True, save_tin=True, quad=True, **ext)
    j_dfeats = pallas_march_bwd(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], j_tin, j_base,
        inp["d_rgb"], inp["d_tfinal"], JConfig(**kw), n_tiles=T_, rays_per_tile=R, chunk=c,
        interpret=True, origins_t=ext["origins_t"], t_lo=ext["t_lo"], t_hi=ext["t_hi"])
    assert int(np.diff(inp["starts"]).max()) > c  # more than one chunk a tile
    feats = T(inp["pair_feats"]).requires_grad_(True)
    rgb, t_final = tbwd.march_stream_diff(
        tmarch.train_features(feats), T(inp["starts"]), T(inp["dirs_t"]), T(inp["eye"]),
        RenderConfig(**kw), c, use_kernels=False, quad=True, **{k: T(v) for k, v in ext.items()})
    keep = inp["keep"]
    for a, b in zip((rgb.detach(), t_final.detach()), (j_rgb, j_t)):
        _close(a.numpy()[keep], np.asarray(b)[keep])
    assert float(t_final.detach().min()) < 0.5
    (torch.sum(rgb * T(inp["d_rgb"])) + torch.sum(t_final * T(inp["d_tfinal"]))).backward()
    got, want = feats.grad.numpy(), np.asarray(j_dfeats)
    cols = range(got.shape[1])
    _grads_close(got, want, cols, tmarch.diff_columns(0), range(3, 12))


def test_merge_and_key_training_match_render_pallas_diff():
    """render_diff at chunk 96, 64x32, 500 gaussians of seed 1, L2 to a
    flat target over every ray but the boundary rays: merge order trains as
    key in both packages (pallas_renderer.py:208-209); JAX's gradient once,
    the port's in merge and in key order against it."""
    kw = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3,
              march_chunk=96, order="merge")
    eye = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0))
    jmodel = JModel.from_scene(j_random_scene(500, seed=1))
    target = np.full((32, 64, 3), 0.3, np.float32)
    cam = Camera.create(width=64, height=32, **eye)
    boundary = _boundary_rays(jmodel.activate(), generate_rays(cam, RenderConfig())[1].numpy(),
                              eye["eye"], 0.01)
    assert boundary.sum() <= 0.005 * boundary.size
    keep = (~boundary)[..., None].astype(np.float32)
    norm = 3.0 * keep.sum()

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(width=64, height=32, **eye),
                                 JConfig(**kw), pair_capacity=100_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / norm

    j_loss, j_grads = jax.value_and_grad(loss_pallas)(jmodel)
    assert tcfg.unsupported_fields(RenderConfig(**kw))  # merge does not render at 96
    for order in ("merge", "key"):
        model = _port_model(jmodel)
        out = render_diff(model.activate(), cam, RenderConfig(**{**kw, "order": order}),
                          method="plain", pair_capacity=100_000)
        loss = torch.sum(T(keep) * (out["rgb"] - T(target)) ** 2) / norm
        loss.backward()
        assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss)), order
        for f in FIELDS:
            a, b = getattr(model, f).grad.numpy(), np.asarray(getattr(j_grads, f))
            assert np.isfinite(a).all(), (order, f)
            assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) <= 1e-3, (order, f)


@pytest.mark.parametrize("chunk,bsub", [(256, 2), (96, 3)])
def test_key_block_mode_matches_jax(chunk, bsub):
    """The JAX suite's TestMeshFast setup (48x32, random_scene(1200,
    seed=4), loop_bound 2, the plane at z = 1.2 as GLASS) under order and
    bounce_order "key" at block-mode chunks of chunk * bsub rows (512 and
    288: above 256, where JAX caps only window and merge order)."""
    js = j_random_scene(1200, seed=4)
    cam = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=48, height=32)
    kw = dict(hit_multiplicity=1, order="key", bounce_order="key", march_chunk=chunk,
              bounce_blocks_per_chunk=bsub, max_per_tile=4096, chunk_skip_transmittance=1e-3)
    jm = jmesh.make_plane(np.array([0.0, 0.0, 1.2], np.float32))
    want = jtracer.render_with_mesh_fast(js, jm, JCamera.create(**cam),
                                         JConfig(mesh_type=JMeshType.GLASS, **kw), loop_bound=2,
                                         interpret=True)
    tm = TriangleMesh.from_numpy({k: np.asarray(getattr(jm, k)) for k in
                                  ("vertices", "normals", "faces", "transform")}, jm.num_faces)
    record = []
    cfg = RenderConfig(mesh_type=MeshType.GLASS, **kw)
    assert tcfg.unsupported_mesh_fields(cfg) == []
    got = ttracer.render_with_mesh_fast(_carry_scene(js), tm, Camera.create(**cam), cfg,
                                        loop_bound=2, use_kernels=False, record=record)
    for k in ("rgb", "alpha"):
        assert psnr(got[k].numpy(), np.asarray(want[k])) >= 50.0, k
    assert got["aux"]["block_dropped"] == int(want["aux"]["block_dropped"])
    assert float(got["alpha"].max()) > 0.5
    args, kwargs = record[1]["k1"]  # the bounced rays' block march
    assert args[4] == chunk * bsub and kwargs["block_sub"] == bsub
    assert int(kwargs["blocks"].numel()) > 0


def test_window_and_merge_refused_by_name_at_other_chunks():
    """unsupported_fields names window and merge order at chunk 96 (and
    check_supported refuses before any work), unsupported_mesh_fields
    window block mode at 128 x 3 = 384 rows and at 96 x 2 = 192; key and
    oddeven pass at every chunk, and window order at the four sort chunks;
    the march refuses the same values with the reason when called
    directly."""
    for order in ("window", "merge"):
        bad = tcfg.unsupported_fields(RenderConfig(order=order, march_chunk=96))
        assert len(bad) == 1 and f"order={order!r} at march chunk 96" in bad[0]
        assert "power of two" in bad[0]
        with pytest.raises(NotImplementedError, match="march chunk 96"):
            render(_carry_scene(j_random_scene(50, seed=0)), Camera.create(**SMALL_CAM),
                   RenderConfig(order=order, march_chunk=96), method="plain")
    for order in ("key", "oddeven"):
        for c in (32, 40, 96, 100, 200, 256, 1000):
            assert tcfg.unsupported_fields(RenderConfig(order=order, march_chunk=c)) == []
    for c in (32, 64, 128, 256, 300, 8):  # chunk_for clamps to [32, 256]
        assert tcfg.unsupported_fields(RenderConfig(order="window", march_chunk=c)) == []
    assert tcfg.unsupported_train_fields(RenderConfig(order="merge", march_chunk=96)) == []
    assert tcfg.unsupported_train_fields(RenderConfig(order="window", march_chunk=96))
    for c, bsub in ((128, 3), (96, 2), (256, 2)):
        bad = tcfg.unsupported_mesh_fields(
            RenderConfig(order="key", bounce_order="window", march_chunk=c,
                         bounce_blocks_per_chunk=bsub))
        assert len(bad) == 1 and f"bounce_order='window' at block-mode chunk {c * bsub}" in bad[0]
    assert tcfg.unsupported_mesh_fields(RenderConfig(bounce_order="merge", march_chunk=64,
                                                     bounce_blocks_per_chunk=2)) == []
    assert tcfg.unsupported_mesh_fields(RenderConfig(order="key", bounce_order="key",
                                                     march_chunk=96,
                                                     bounce_blocks_per_chunk=3)) == []
    starts = torch.zeros(2, dtype=torch.int32)
    feats, dirs = torch.zeros((0, tmarch.ROW)), torch.zeros((1, 32, 3))
    for order in ("window", "merge"):
        with pytest.raises(NotImplementedError, match="power of two"):
            tmarch.march(starts, feats, dirs, RenderConfig(order=order), 96)
    assert tmarch.march(starts, feats, dirs, RenderConfig(order="key"), 96)[0].shape == (1, 32, 3)


def test_entry_points_march_the_asked_chunk(tmp_path):
    """GaussianRayTracer, the ray-sharded renderer (two CPU shards),
    render_rolling, Trainer(mesh=) and `cli render --order key
    --march-chunk 96` run key order at chunk 96 on the CPU: the tracer's
    and the sharded frame are render(method="plain")'s bit for bit, the
    rolling frame with both poses equal within 60 dB of it (the scalar
    response from per-ray origins against the quad one from the eye), the
    sharded trainer's two steps finite."""
    from gaussian_ray_tracing_tpu_torch import cli
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer
    from gaussian_ray_tracing_tpu_torch.models.rolling import render_rolling
    from gaussian_ray_tracing_tpu_torch.parallel.mesh import make_mesh
    from gaussian_ray_tracing_tpu_torch.parallel.sharded import render_pallas_sharded
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
    from gaussian_ray_tracing_tpu_torch.train.trainer import Trainer

    scene, cam = random_scene(2000, seed=2), Camera.create(**SMALL_CAM)
    cfg = RenderConfig(hit_multiplicity=1, order="key", march_chunk=96)
    want = render(scene, cam, cfg, method="plain")["rgb"]
    shards = make_mesh(2, devices=[torch.device("cpu")] * 2)
    sharded = render_pallas_sharded(scene, cam, cfg, shards)
    assert torch.equal(sharded["rgb"], want)
    tracer = GaussianRayTracer(scene=scene, config=cfg)
    tracer.set_size(SMALL_CAM["width"], SMALL_CAM["height"])
    tracer.update_camera(cam)
    assert torch.equal(tracer.render(method="plain")["rgb"], want)
    rolled = render_rolling(scene, cam, cam, cfg, use_kernels=False)["rgb"]
    assert psnr(rolled.numpy(), want.numpy()) >= 60.0
    trainer = Trainer(GaussianModel.from_scene(random_scene(500, seed=3)), cfg, mesh=shards)
    losses = trainer.fit([(cam, torch.full(want.shape, 0.3))], steps=2)
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = tmp_path / "key96.png"
    cli.main(["render", "--synthetic", "2000", "--width", "96", "--height", "64", "--order",
              "key", "--march-chunk", "96", "--device", "cpu", "-o", str(out)])
    assert out.stat().st_size > 0

def test_tiled_window_order_at_chunk_96_matches_jax(monkeypatch):
    """The tiled march sorts each ray's candidates in window order at any
    chunk: render_tiled at chunk 96 on JAX's rays and feature table with
    xla_rounding, against JAX's, atol 2e-5 off the boundary rays
    (tests/test_torch_tiled.py's setup, random_scene(3000, seed=3))."""
    js = j_random_scene(3000, seed=3)
    ts = _carry_scene(js)
    kw = dict(hit_multiplicity=1, max_per_tile=4096, order="window", march_chunk=96)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    assert tcfg.unsupported_tiled_fields(cfg) == [] and tcfg.unsupported_fields(cfg)
    want = jtiled.render_tiled(js, JCamera.create(**SMALL_CAM), jcfg, pair_capacity=200_000,
                               return_aux=True)
    rays = jax.jit(lambda c: j_generate_rays(c, jcfg))(JCamera.create(**SMALL_CAM))
    table = jax.jit(lambda s: jtiled.feature_table(s, jcfg))(js)
    monkeypatch.setattr(ttiled, "generate_rays", lambda cam, c: tuple(T(r) for r in rays))
    monkeypatch.setattr(ttiled, "feature_table", lambda scene, c: tuple(T(x) for x in table))
    got = ttiled.render_tiled(ts, Camera.create(**SMALL_CAM), cfg, pair_capacity=200_000,
                              return_aux=True, xla_rounding=True)
    assert got["aux"] == {"n_pairs": int(want["aux"]["n_pairs"]), "n_dropped": 0}
    keep = ~_tiled_boundary_rays(js, np.asarray(rays[1]), SMALL_CAM["eye"], 0.01)
    assert keep.mean() > 0.99
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(got[k].numpy()[keep], np.asarray(want[k])[keep], atol=2e-5,
                                   err_msg=k)
