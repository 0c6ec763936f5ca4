"""The port's multi-device layer (gaussian_ray_tracing_tpu_torch/parallel/)
on meshes of 8 (or 4 x 2) shards on the CPU, against the port's
single-device renderers and trainer and against the JAX package.

Bars are the JAX suite's own (tests/test_parallel.py, whose cases these
mirror; there they are marked slow, here they stay small enough to run in
the default subset):
  - the mesh collectives: exact;
  - the banded binning against JAX bin_pairs(tile_rows=) on the JAX
    footprints: identical gid, starts and counts, band by band; the bands
    concatenated equal the unbanded stream;
  - render_pallas_sharded against render_gpu: bit for bit
    (test_parallel.py:120-145 with conic_cull off; the port refuses
    conic_cull); against JAX render_pallas, the port's single-device bars
    (window >= 60 dB, key >= 70 dB and max abs <= 1e-2;
    tests/test_torch_render.py);
  - sharded gradients against single-device ones: rtol 3e-5, atol 5e-7
    (test_parallel.py:224-262); against JAX render_pallas_diff, 1e-3 of
    each field's largest entry with the boundary rays left out of the loss
    (tests/test_torch_train.py);
  - the sharded train step (test_parallel.py:78-117): loss rtol 1e-4,
    means atol 1e-4, N/8 rows of Adam moments a shard, a falling loss;
  - depth slabs on K1 (test_parallel.py:265-310), the tiled and oracle
    ray shards (:39-59) and the gaussian-sharded renderers (:62-75,
    148-221) at the same bars; render_tiled_sharded against JAX's with
    xla_rounding and the JAX rays and table (tests/test_torch_tiled.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays as j_generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import tiled as jtiled
from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JModel
from gaussian_ray_tracing_tpu.models.pallas_renderer import render_pallas, render_pallas_diff
from gaussian_ray_tracing_tpu.ops import tiles as jtiles
from gaussian_ray_tracing_tpu.ops.response import adaptive_radius as j_adaptive_radius
from gaussian_ray_tracing_tpu.parallel import sharded as jsharded
from gaussian_ray_tracing_tpu.parallel.mesh import make_mesh as j_make_mesh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models import tiled as ttiled
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import render_gpu, render_gpu_diff
from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle, render_rays_oracle
from gaussian_ray_tracing_tpu_torch.ops import tiles as ttiles
from gaussian_ray_tracing_tpu_torch.parallel import mesh as pmesh
from gaussian_ray_tracing_tpu_torch.parallel import sharded as S
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.train import trainer as ttrainer
from gaussian_ray_tracing_tpu_torch.train.density import DensityConfig
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_train import _boundary_rays

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8
CFG = RenderConfig(hit_multiplicity=1)
EYE = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0))
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "sh")
T = lambda x: torch.from_numpy(np.array(x))


def _port_scene(js) -> GaussianScene:
    return GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                    js.num_active)


@pytest.fixture(scope="module")
def ray_mesh():
    return pmesh.make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def gauss_mesh():
    return pmesh.make_mesh(8, axis=pmesh.GAUSS_AXIS, devices=CPU8)


# --- the mesh and its collectives ------------------------------------------

@pytest.mark.parametrize("op", ["all_gather", "psum", "pmax", "ppermute"])
def test_collectives(ray_mesh, op):
    xs = [torch.tensor([float(s), 10.0 - s]) for s in ray_mesh.local]
    if op == "all_gather":
        want = torch.stack(xs)
        for got in pmesh.all_gather(ray_mesh, xs):
            assert torch.equal(got, want)  # in shard order on every shard
    elif op == "psum":
        for got in pmesh.psum(ray_mesh, xs):
            assert torch.equal(got, torch.tensor([28.0, 52.0]))
    elif op == "pmax":
        for got in pmesh.pmax(ray_mesh, xs):
            assert torch.equal(got, torch.tensor([7.0, 10.0]))
    else:  # a ring: shard i sends to i + 1
        got = pmesh.ppermute(ray_mesh, xs, [(i, (i + 1) % 8) for i in range(8)])
        for s, g in zip(ray_mesh.local, got):
            assert torch.equal(g, xs[(s - 1) % 8])
        half = pmesh.ppermute(ray_mesh, xs, [(0, 1)])  # receivers only get zeros
        assert torch.equal(half[1], xs[0]) and not half[2].any()


def test_mesh_2d_groups_and_placement():
    m = pmesh.make_mesh_2d(4, 2, devices=CPU8)
    assert m.shape == {"rays": 4, "gauss": 2} and m.size == 8
    assert m.group(5, "gauss") == [4, 5] and m.group(5, "rays") == [1, 3, 5, 7]
    x = torch.arange(8.0).reshape(4, 2)
    blocks = pmesh.ray_axis_sharding(m, x)
    assert all(torch.equal(b, x[m.index(s, "rays")][None]) for s, b in zip(m.local, blocks))
    assert all(torch.equal(r, x) for r in pmesh.replicated(m, x))


def test_make_mesh_without_devices_needs_cuda_devices():
    """No silent CPU fallback: without devices= the shards take CUDA
    devices, and too few of them raise."""
    with pytest.raises(RuntimeError, match="CUDA devices"):
        pmesh.make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        pmesh.make_mesh(8, devices=CPU8[:3])


# --- the tile-row band -------------------------------------------------------

def _jax_footprints(js, cam_kw):
    jc = JCamera.create(**cam_kw)
    r = j_adaptive_radius(js.opacities, 0.01)
    jfp = jtiles.project_footprints_conic(js.means, js.scales, js.quats, r,
                                         r * jnp.max(js.scales, axis=-1), jc, JConfig())
    tfp = ttiles.Footprint(*(T(getattr(jfp, k)) for k in ttiles.Footprint._fields[:6]))
    return jfp, jc, tfp, Camera.create(**cam_kw)


@pytest.mark.parametrize("height,n", [(64, 8), (80, 3)])
def test_banded_bin_pairs_matches_jax(height, n):
    """96 x height, 2000 gaussians, n bands of ceil(rows / n) tile rows:
    each band's stream equals JAX bin_pairs(tile_rows=)'s (bands past the
    grid and the partly padded last band included), and the in-grid
    tiles of the bands, concatenated, are the unbanded stream."""
    js = j_random_scene(2000, seed=3)
    jfp, jc, tfp, tc = _jax_footprints(js, dict(EYE, width=96, height=height))
    tx_n, ty_n = ttiles.num_tiles(tc, CFG)
    rows = -(-ty_n // n)
    full = ttiles.bin_pairs(tfp, tc, RenderConfig(), 100_000)
    gids, starts = [], [0]
    for d in range(n):
        band = (d * rows, rows)
        want = jtiles.bin_pairs(jfp, jc, JConfig(), 65_536, tile_rows=band)
        got = ttiles.bin_pairs(tfp, tc, RenderConfig(), 65_536, tile_rows=band)
        k = int(want.n_pairs)
        assert int(got.n_pairs) == k and int(got.n_dropped) == int(want.n_dropped) == 0
        assert np.array_equal(got.starts.numpy(), np.asarray(want.starts))
        assert np.array_equal(got.gid[:k].numpy(), np.asarray(want.gid)[:k])
        in_grid = max(0, min(rows, ty_n - d * rows)) * tx_n
        gids.append(got.gid[:int(got.starts[in_grid])])
        starts += (got.starts[1:in_grid + 1] + starts[-1]).tolist()
    k = int(full.n_pairs)
    assert torch.equal(torch.cat(gids), full.gid[:k])
    assert starts == full.starts.tolist()


# --- the ray-sharded forward and training -----------------------------------

@pytest.mark.parametrize("order", ["key", "window"])
def test_render_pallas_sharded_bit_identical_to_render_gpu(ray_mesh, order):
    """96x64, 2000 gaussians: 4 tile rows over 8 shards (4 bands past the
    grid), with and without a frame capacity."""
    scene = random_scene(2000, seed=3)
    cam = Camera.create(**EYE, width=96, height=64)
    cfg = CFG.replace(order=order)
    a = render_gpu(scene, cam, cfg, use_kernels=False)
    for cap in (None, 100_000):
        b = S.render_pallas_sharded(scene, cam, cfg, ray_mesh, pair_capacity=cap)
        assert b["n_dropped"] == 0
        assert torch.equal(a["rgb"], b["rgb"]) and torch.equal(a["alpha"], b["alpha"])


@pytest.mark.parametrize("order", ["key", "window"])
def test_render_pallas_sharded_matches_jax_render_pallas(ray_mesh, order):
    js = j_random_scene(2000, seed=3)
    cam_kw = dict(EYE, width=96, height=64)
    kw = dict(hit_multiplicity=1, order=order)
    ref = render_pallas(js, JCamera.create(**cam_kw), JConfig(**kw), pair_capacity=100_000,
                        interpret=True)
    out = S.render_pallas_sharded(_port_scene(js), Camera.create(**cam_kw), RenderConfig(**kw),
                                  ray_mesh, pair_capacity=100_000)
    a, b = out["rgb"].numpy(), np.asarray(ref["rgb"])
    if order == "window":
        assert psnr(a, b) >= 60.0 and psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60
    else:
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


def _grads(model, render_fn, target, keep=None):
    for p in model.parameters():
        p.grad = None
    err = (render_fn(model.activate())["rgb"] - target) ** 2
    loss = torch.mean(err) if keep is None else torch.sum(keep * err) / (3.0 * keep.sum())
    loss.backward()
    return loss.detach(), {f: getattr(model, f).grad.clone() for f in FIELDS}


@pytest.mark.parametrize("order", ["key", "window"])
def test_sharded_diff_gradients_match_single_device(ray_mesh, order):
    """test_parallel.py:224-262: 64x32, 600 gaussians of seed 6, L2 to a
    flat 0.3 target."""
    cfg = CFG.replace(order=order)
    model = GaussianModel.from_scene(random_scene(600, seed=6)).requires_grad_(True)
    cam = Camera.create(**EYE, width=64, height=32)
    target = torch.full((32, 64, 3), 0.3)
    _, gs = _grads(model, lambda s: S.render_pallas_sharded_diff(
        s, cam, cfg, ray_mesh, pair_capacity=100_000), target)
    _, g1 = _grads(model, lambda s: render_gpu_diff(s, cam, cfg, pair_capacity=100_000,
                                                    use_kernels=False), target)
    for f in FIELDS:
        assert float(g1[f].abs().max()) > 0.0, f
        np.testing.assert_allclose(gs[f].numpy(), g1[f].numpy(), rtol=3e-5, atol=5e-7,
                                   err_msg=f)


def test_sharded_diff_gradients_match_jax_render_pallas_diff(ray_mesh):
    """64x32, 500 gaussians of seed 2, key order, skip 1e-3: the port's
    single-device bar against JAX, boundary rays out of the loss."""
    kw = dict(hit_multiplicity=1, order="key", max_per_tile=4096,
              chunk_skip_transmittance=1e-3)
    jmodel = JModel.from_scene(j_random_scene(500, seed=2))
    cam = Camera.create(**EYE, width=64, height=32)
    cfg = RenderConfig(**kw)
    boundary = _boundary_rays(jmodel.activate(), generate_rays(cam, cfg)[1].numpy(),
                              EYE["eye"], cfg.alpha_min)
    keep = (~boundary)[..., None].astype(np.float32)
    target = np.full((32, 64, 3), 0.3, np.float32)

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(**EYE, width=64, height=32),
                                 JConfig(**kw), pair_capacity=100_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / (3.0 * keep.sum())

    j_loss, j_grads = jax.value_and_grad(loss_pallas)(jmodel)
    model = GaussianModel.from_numpy({k: np.asarray(getattr(jmodel, k)) for k in FIELDS},
                                     jmodel.num_active).requires_grad_(True)
    loss, grads = _grads(model, lambda s: S.render_pallas_sharded_diff(
        s, cam, cfg, ray_mesh, pair_capacity=100_000), torch.from_numpy(target),
        torch.from_numpy(keep))
    assert abs(float(loss) - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    for f in FIELDS:
        a, b = grads[f].numpy(), np.asarray(getattr(j_grads, f))
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) <= 1e-3, f


def _train_setup():
    cfg = CFG.replace(max_per_tile=128)
    cam = Camera.create(eye=(0, 0.3, 2.7), lookat=(0, 0, 0), width=64, height=32)
    scene = random_scene(100, seed=5, mean_scale=0.05, density_scaling=False)
    target = torch.zeros((32, 64, 3))
    target[..., 0] = 0.5
    return cfg, cam, scene, target


def test_sharded_train_step_matches_single_device(ray_mesh):
    """test_parallel.py:78-117, default Adam at lr 1e-2."""
    cfg, cam, scene, target = _train_setup()
    single = ttrainer.Trainer(GaussianModel.from_scene(scene), cfg, lr=1e-2)
    sharded = ttrainer.Trainer(GaussianModel.from_scene(scene), cfg, lr=1e-2, mesh=ray_mesh)
    m1 = single.step_fn(single.model, cam, target)
    m2 = sharded.step_fn(sharded.model, cam, target)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    np.testing.assert_allclose(single.model.means.detach().numpy(),
                               sharded.model.means.detach().numpy(), atol=1e-4)
    # ZeRO-1: each shard holds 1/8 of every slot-axis moment
    n = scene.num_gaussians
    opt = sharded.optimizer
    assert isinstance(opt, ttrainer.ZeroOptimizer) and len(opt.shards) == 8
    for s, shard_opt, _ in opt.shards:
        moments = [v for st in shard_opt.state.values() for v in st.values() if v.dim() >= 1]
        assert len(moments) == 2 * len(FIELDS)
        assert all(v.shape[0] == n // 8 and v.device == ray_mesh.device(s) for v in moments)
    prev = float(m2["loss"])
    for _ in range(3):
        m = sharded.step_fn(sharded.model, cam, target)
    assert float(m["loss"]) < prev


def test_sharded_trainer_density_and_3dgs_optimizer_match_single_device(ray_mesh):
    """Trainer.fit with density control (slot births reset the moments of
    the right shard's rows) and the 3DGS per-field Adam: losses at rtol
    1e-4 and the same population; an uneven capacity keeps whole moments."""
    cfg, cam, scene, target = _train_setup()
    dens = DensityConfig(densify_from_step=2, densify_until_step=4, densify_every=2,
                         opacity_reset_every=0, grad_threshold=1e-6)
    runs = []
    for mesh in (None, ray_mesh):
        model = GaussianModel.from_scene(scene)
        opt = ttrainer.gaussian_optimizer(model, scene_extent=1.0, total_steps=10)
        tr = ttrainer.Trainer(model, cfg, mesh=mesh, optimizer=opt, density=dens)
        runs.append((tr.fit([(cam, target)], steps=6), tr.alive(), tr))
    (l1, a1, t1), (l2, a2, t2) = runs
    assert a1 == a2 > scene.num_active
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    whole = t1.optimizer.state[t1.model.means]["exp_avg"]
    parts = [st[0] for st in (list(o.state.values()) for _, o, _ in t2.optimizer.shards)]
    np.testing.assert_allclose(torch.cat([p["exp_avg"] for p in parts]).numpy(),
                               whole.numpy(), atol=1e-6)
    uneven = GaussianModel.from_scene(scene)
    uneven = GaussianModel(*(getattr(uneven, f)[:250].clone() for f in FIELDS), num_active=100)
    tr = ttrainer.Trainer(uneven, cfg, mesh=ray_mesh)
    assert isinstance(tr.optimizer, torch.optim.Adam)
    assert np.isfinite(tr.fit([(cam, target)], steps=1)).all()


def test_sharded_trainer_checkpoint_round_trip(ray_mesh, tmp_path):
    """A sharded trainer's checkpoint restores each shard's moments and
    the step, and the next step is the one the saved trainer takes."""
    cfg, cam, scene, target = _train_setup()
    a = ttrainer.Trainer(GaussianModel.from_scene(scene), cfg, lr=1e-2, mesh=ray_mesh)
    a.fit([(cam, target)], steps=2)
    a.save_checkpoint(str(tmp_path))
    b = ttrainer.Trainer(GaussianModel.from_scene(scene), cfg, lr=1e-2, mesh=ray_mesh)
    b.restore_checkpoint(str(tmp_path))
    assert b.steps_done == 2
    for (_, oa, _), (_, ob, _) in zip(a.optimizer.shards, b.optimizer.shards):
        for sa, sb in zip(oa.state.values(), ob.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))
    assert a.fit([(cam, target)], steps=3) == b.fit([(cam, target)], steps=3)


def test_sharded_trainer_refusals(ray_mesh):
    cfg, cam, scene, target = _train_setup()
    model = GaussianModel.from_scene(scene)
    with pytest.raises(ValueError, match="method"):
        ttrainer.Trainer(model, cfg, mesh=ray_mesh, method="plain")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.Trainer(model, cfg, mesh=ray_mesh, method="gpu")
    with pytest.raises(ValueError, match="1-D"):
        ttrainer.Trainer(model, cfg, mesh=pmesh.make_mesh_2d(4, 2, devices=CPU8))


def test_tiled_sharded_trainer_matches_single_device(ray_mesh):
    """Trainer(method="tiled", mesh=): the tiled march's autograd over ray
    shards, the JAX trainer's use_pallas=False path with a mesh."""
    cfg, cam, scene, target = _train_setup()
    cfg = cfg.replace(order="key")
    losses = [ttrainer.Trainer(GaussianModel.from_scene(scene), cfg, lr=1e-2, mesh=mesh,
                               method="tiled").fit([(cam, target)], steps=2)
              for mesh in (None, ray_mesh)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


# --- depth slabs and the reference renderers ---------------------------------

def test_render_pallas_slabs(gauss_mesh):
    """test_parallel.py:265-310: 64x32, 1500 gaussians, window order, c=64."""
    scene = random_scene(1500, seed=3)
    cam = Camera.create(**EYE, width=64, height=32)
    cfg = CFG.replace(order="window", march_chunk=64)
    g = S.render_pallas_slabs(scene, cam, cfg, gauss_mesh, pair_capacity=65_536, comm="gather")
    r = S.render_pallas_slabs(scene, cam, cfg, gauss_mesh, pair_capacity=65_536, comm="ring")
    assert g["n_dropped"] == 0 and r["n_dropped"] == 0
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(r[k].numpy(), g[k].numpy(), atol=2e-5)
    ts = S.render_gaussian_sharded_fast(scene, cam, cfg.replace(max_per_tile=4096), gauss_mesh,
                                        pair_capacity=65_536)
    assert psnr(ts["rgb"].numpy(), r["rgb"].numpy()) > 40.0
    a = render_gpu(scene, cam, cfg, pair_capacity=200_000, use_kernels=False)
    assert psnr(a["rgb"].numpy(), r["rgb"].numpy()) > 30.0
    assert r["pairs_max_shard"] * 4 < r["n_pairs"] == g["n_pairs"]


@pytest.fixture(scope="module")
def scene600():
    return random_scene(600, seed=21, mean_scale=0.03, density_scaling=False)


CAM600 = dict(eye=(0, 0.3, 2.7), lookat=(0, 0, 0), width=64, height=48)


def test_tiled_sharded_matches_single(scene600, ray_mesh):
    cam = Camera.create(**CAM600)
    ref = ttiled.render_tiled(scene600, cam, CFG)
    out = S.render_tiled_sharded(scene600, cam, CFG, ray_mesh)
    assert psnr(ref["rgb"].numpy(), out["rgb"].numpy()) > 55.0
    np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"].numpy(), atol=2e-2)


def test_tiled_sharded_matches_jax(ray_mesh, monkeypatch):
    """64x64, 500 gaussians of seed 2, key order, the JAX package's 8-device
    render_tiled_sharded; xla_rounding with the JAX rays and table (PR 13's
    rule, tests/test_torch_tiled.py): atol 2e-5 off the boundary rays."""
    js = j_random_scene(500, seed=2)
    cam_kw = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=64)
    kw = dict(hit_multiplicity=1, order="key")
    jcfg = JConfig(**kw)
    want = jsharded.render_tiled_sharded(js, JCamera.create(**cam_kw), jcfg, j_make_mesh(8),
                                         pair_capacity=40_000)
    rays = jax.jit(lambda c: j_generate_rays(c, jcfg))(JCamera.create(**cam_kw))
    table = jax.jit(lambda s: jtiled.feature_table(s, jcfg))(js)
    monkeypatch.setattr(ttiled, "generate_rays", lambda cam, cfg: tuple(T(r) for r in rays))
    monkeypatch.setattr(ttiled, "feature_table", lambda scene, cfg: tuple(T(x) for x in table))
    got = S.render_tiled_sharded(_port_scene(js), Camera.create(**cam_kw), RenderConfig(**kw),
                                 ray_mesh, pair_capacity=40_000, xla_rounding=True)
    keep = ~_boundary_rays(js, np.asarray(rays[1]), cam_kw["eye"], 0.01)
    assert keep.mean() > 0.99
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(got[k].numpy()[keep], np.asarray(want[k])[keep], atol=2e-5)


def test_rays_sharded_oracle_matches_single(scene600, ray_mesh):
    origins, dirs, _ = generate_rays(Camera.create(**CAM600), CFG)
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    ref = render_rays_oracle(scene600, o, d, CFG)
    out = S.render_rays_sharded_oracle(scene600, o, d, CFG, ray_mesh)
    assert psnr(ref[0].numpy(), out[0].numpy()) > 55.0
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2)


@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_gaussian_sharded_close_to_oracle(scene600, shape):
    mesh = (pmesh.make_mesh(8, axis=pmesh.GAUSS_AXIS, devices=CPU8) if shape == "1d"
            else pmesh.make_mesh_2d(4, 2, devices=CPU8))
    cam = Camera.create(**CAM600)
    ref = render_oracle(scene600, cam, CFG)
    out = S.render_gaussian_sharded(scene600, cam, CFG, mesh)
    assert psnr(ref["rgb"].numpy(), out["rgb"].numpy()) >= 40.0


def test_gaussian_sharded_fast_matches_oracle_slabs(gauss_mesh):
    scene = random_scene(1500, seed=3)
    cam = Camera.create(**EYE, width=64, height=32)
    cfg = CFG.replace(order="window", max_per_tile=4096)
    a = S.render_gaussian_sharded(scene, cam, cfg, gauss_mesh)
    b = S.render_gaussian_sharded_fast(scene, cam, cfg, gauss_mesh, pair_capacity=100_000)
    assert psnr(a["rgb"].numpy(), b["rgb"].numpy()) > 45.0


def test_gaussian_slab_exact_straddlers_dense(gauss_mesh):
    scene = random_scene(800, seed=7, mean_scale=0.12, density_scaling=False)
    cam = Camera.create(**EYE, width=64, height=32)
    cfg = CFG.replace(order="window", max_per_tile=2048, march_chunk=2048)
    ref = render_oracle(scene, cam, cfg)
    ex = S.render_gaussian_sharded_fast(scene, cam, cfg, gauss_mesh, pair_capacity=100_000,
                                        straddle="exact", overlap_capacity=448)
    assert ex["n_straddle_dropped"] == 0
    p_ex = psnr(ref["rgb"].numpy(), ex["rgb"].numpy())
    sl = S.render_gaussian_sharded_fast(scene, cam, cfg, gauss_mesh, pair_capacity=100_000)
    p_sl = psnr(ref["rgb"].numpy(), sl["rgb"].numpy())
    assert p_ex >= 40.0 and p_ex > p_sl, (p_ex, p_sl)


def test_gaussian_ring_matches_allgather_fold(gauss_mesh):
    scene = random_scene(1500, seed=3)
    cam = Camera.create(**EYE, width=64, height=32)
    cfg = CFG.replace(order="window", max_per_tile=4096)
    a = S.render_gaussian_sharded_fast(scene, cam, cfg, gauss_mesh, pair_capacity=100_000)
    b = S.render_gaussian_ring(scene, cam, cfg, gauss_mesh, pair_capacity=100_000)
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=2e-5)
