"""The ported training slice against the JAX package on the CPU: gradients
of the differentiable render w.r.t. every raw field against
render_pallas_diff (Pallas in interpret mode), train steps against JAX's
make_train_step(use_pallas=True), the trainer and `cli fit`, and the
values training refuses.

One set of raw weights feeds both packages (GaussianModel.to_numpy /
from_numpy). Bars: per raw field max|a - b| / max|b| <= 1e-3 (the JAX
suite's hand-written-backward bar, tests/test_pallas.py:264-269), the loss
at rtol 1e-4, train-step losses at rtol 1e-3. Losses, not parameters, are
compared after steps: Adam turns float noise on near-zero gradient entries
into steps of +-lr.

The gradient test leaves out of the loss, on both sides, the boundary
rays: those on which some gaussian's peak alpha lies within ALPHA_EPS
(relative) of alpha_min, computed in float64. There the gate may pass on
one side only: XLA's CPU backend evaluates the response with fused
multiply-adds, the port rounds each float32 operation. On seed 6, the JAX
suite's, gaussian 134 reaches ray 24 of tile 1 at alpha 0.0100006, 6e-5
relative above alpha_min; kept in the loss, that one ray moves raw_quats by
1.34e-3 of its largest gradient (means 9.2e-4). Measured: 4, 0 and 2
boundary rays of 2048 on seeds 1, 2 and 6, worst field 2.5e-4 (seed 2,
raw_quats)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JModel
from gaussian_ray_tracing_tpu.models.pallas_renderer import render_pallas_diff
from gaussian_ray_tracing_tpu.models.tiled import render_tiled
from gaussian_ray_tracing_tpu.scene.ply import load_ply as j_load_ply
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu.train import trainer as jtrainer
from gaussian_ray_tracing_tpu_torch import cli
from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.ops.response import canonical_frames, max_response
from gaussian_ray_tracing_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)
# the JAX suite's training config (tests/test_pallas.py:30): key order, no
# render-only chunk skip
KW = dict(hit_multiplicity=1, order="key", max_per_tile=4096, chunk_skip_transmittance=1e-3)
EYE = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0))
ALPHA_EPS = 1e-4  # boundary rays: |peak alpha / alpha_min - 1| below this


def _boundary_rays(scene, dirs, eye, alpha_min: float) -> np.ndarray:
    """dirs (..., 3) -> bool (...): the rays on which some gaussian of the
    (JAX) scene peaks within ALPHA_EPS of alpha_min, in float64."""
    f64 = lambda x: torch.from_numpy(np.asarray(x, np.float64)[: scene.num_active])
    means, ops = f64(scene.means), f64(scene.opacities)
    M = canonical_frames(f64(scene.scales), f64(scene.quats))
    d = torch.from_numpy(np.asarray(dirs, np.float64).reshape(-1, 1, 3))
    near = []
    for part in d.split(1024):
        resp, _ = max_response(means, M, torch.tensor(eye, dtype=torch.float64), part)
        near.append((torch.clamp(resp * ops, max=0.99) / alpha_min - 1.0).abs() < ALPHA_EPS)
    return torch.cat(near).any(dim=1).reshape(np.shape(dirs)[:-1]).numpy()


def _port_model(jmodel) -> GaussianModel:
    arrays = {k: np.asarray(getattr(jmodel, k)) for k in FIELDS}
    return GaussianModel.from_numpy(arrays, jmodel.num_active).requires_grad_(True)


@pytest.mark.parametrize("seed", [1, 2, 6])
def test_render_diff_gradients_match_render_pallas_diff(seed):
    """64x32, 500 gaussians, key order, skip 1e-3, L2 to a flat target over
    every ray but the boundary rays (module docstring)."""
    jmodel = JModel.from_scene(j_random_scene(500, seed=seed))
    target = np.full((32, 64, 3), 0.3, np.float32)
    cam = Camera.create(width=64, height=32, **EYE)
    cfg = RenderConfig(**KW)
    boundary = _boundary_rays(jmodel.activate(), generate_rays(cam, cfg)[1].numpy(),
                              EYE["eye"], cfg.alpha_min)
    assert boundary.sum() <= 0.005 * boundary.size  # a few rays, never a region
    keep = (~boundary)[..., None].astype(np.float32)
    norm = 3.0 * keep.sum()

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(width=64, height=32, **EYE),
                                 JConfig(**KW), pair_capacity=100_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / norm

    j_loss, j_grads = jax.value_and_grad(loss_pallas)(jmodel)
    model = _port_model(jmodel)
    out = render_diff(model.activate(), cam, cfg, method="plain", pair_capacity=100_000)
    loss = torch.sum(torch.from_numpy(keep) * (out["rgb"] - torch.from_numpy(target)) ** 2) / norm
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    for f in FIELDS:
        a = getattr(model, f).grad.numpy()
        b = np.asarray(getattr(j_grads, f))
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) <= 1e-3, f
    assert np.abs(model.sh.grad[:, 1:].numpy()).max() == 0.0  # sh 0 only


@pytest.mark.parametrize("order,degree,model", [("window", 0, "pinhole"), ("key", 3, "pinhole"),
                                                ("window", 3, "fisheye")])
def test_render_diff_training_modes_match_render_pallas_diff(order, degree, model):
    """Window order (c=32), SH 3 and the fisheye camera: 64x32, 500
    gaussians of seed 1 with all 16 SH coefficients, L2 to a flat target
    over every ray but the boundary rays; per raw field at the 1e-3 bar,
    the higher SH bands included."""
    from gaussian_ray_tracing_tpu.config import CameraModel as JModelEnum

    kw = {**KW, "order": order, "march_chunk": 32, "sh_degree": degree}
    jmodel = JModel.from_scene(j_random_scene(500, seed=1))
    target = np.full((32, 64, 3), 0.3, np.float32)
    cam = Camera.create(width=64, height=32, **EYE)
    cfg = RenderConfig(**kw, camera_model=__import__(
        "gaussian_ray_tracing_tpu_torch.config", fromlist=["CameraModel"]).CameraModel(model))
    _, dirs, valid = generate_rays(cam, cfg)
    boundary = _boundary_rays(jmodel.activate(), dirs.numpy(), EYE["eye"], cfg.alpha_min)
    assert boundary.sum() <= 0.005 * boundary.size
    keep = ((~boundary) & valid.numpy())[..., None].astype(np.float32)
    norm = 3.0 * keep.sum()

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(width=64, height=32, **EYE),
                                 JConfig(**kw, camera_model=JModelEnum(model)),
                                 pair_capacity=100_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / norm

    j_loss, j_grads = jax.value_and_grad(loss_pallas)(jmodel)
    port = _port_model(jmodel)
    out = render_diff(port.activate(), cam, cfg, method="plain", pair_capacity=100_000)
    loss = torch.sum(torch.from_numpy(keep) * (out["rgb"] - torch.from_numpy(target)) ** 2) / norm
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    for f in FIELDS:
        a = getattr(port, f).grad.numpy()
        b = np.asarray(getattr(j_grads, f))
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) <= 1e-3, f
    higher = np.abs(port.sh.grad[:, 1:].numpy())
    assert (higher.max() > 0) == (degree > 0) and not higher[:, (degree + 1) ** 2 - 1:].any()


def test_train_steps_match_jax():
    """3 steps of make_train_step (Adam 5e-3, L2) from the same weights as
    JAX's make_train_step(use_pallas=True) (tests/test_pallas.py:466-488)."""
    jcfg = JConfig(**KW)
    jcam = JCamera.create(width=48, height=32, **EYE)
    target = render_tiled(j_random_scene(300, seed=8), jcam, jcfg)["rgb"]
    jmodel = JModel.from_scene(j_random_scene(200, seed=9))
    tx = jtrainer.default_optimizer(5e-3)
    jstep = jtrainer.make_train_step(jcfg, tx, use_pallas=True)
    state = jtrainer.TrainState.create(jmodel, tx)
    j_losses = []
    for _ in range(3):
        state, m = jstep(state, jcam, target)
        j_losses.append(float(m["loss"]))

    model = _port_model(jmodel)
    step = ttrainer.make_train_step(RenderConfig(**KW), ttrainer.default_optimizer(model, 5e-3),
                                    method="plain")
    cam, t_target = Camera.create(width=48, height=32, **EYE), torch.from_numpy(np.array(target))
    losses = [float(step(model, cam, t_target)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    assert losses[-1] < losses[0]


def test_trainer_fit_is_resume_aware_and_saves(tmp_path):
    """Trainer.fit runs up to `steps` in total, over the views in turn, on
    the plain versions for CPU tensors (no kernel launch)."""
    cfg = RenderConfig(**KW)
    cam = Camera.create(width=32, height=32, **EYE)
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    target = render(random_scene(300, seed=8), cam, cfg)["rgb"]
    trainer = ttrainer.Trainer(GaussianModel.from_scene(random_scene(200, seed=9)),
                               config=cfg, lr=5e-3)
    before = (tmarch.march.launches, tbwd.march_bwd.launches)
    first = trainer.fit([(cam, target)], steps=2)
    assert len(first) == 2 and trainer.steps_done == 2
    assert trainer.fit([(cam, target)], steps=3) and trainer.steps_done == 3
    assert trainer.fit([(cam, target)], steps=3) == []
    assert (tmarch.march.launches, tbwd.march_bwd.launches) == before
    assert trainer.alive() == 200
    trainer.save(str(tmp_path / "fit.ply"))
    back = j_load_ply(str(tmp_path / "fit.ply"))
    assert back.num_active == 200
    np.testing.assert_array_equal(np.asarray(back.means)[:200],
                                  trainer.model.means.detach().numpy()[:200])


@pytest.mark.parametrize("change", [
    dict(order="window"),
    dict(sh_degree=1),
    dict(order="merge"),
    dict(camera_model=__import__("gaussian_ray_tracing_tpu_torch.config",
                                 fromlist=["CameraModel"]).CameraModel.FISHEYE),
])
def test_training_refuses_unported_configs(change):
    """The configs training once refused now train: two steps of
    make_train_step (and one of Trainer.fit) on a 32x32 frame give finite
    losses, move the weights and, at SH 1, reach sh[:, 1:4]; merge trains
    exactly as key does (the reference maps it to key)."""
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    cfg = RenderConfig(**{**KW, **change})
    cam = Camera.create(width=32, height=32, **EYE)
    target = torch.full((32, 32, 3), 0.3)

    def steps(c):
        model = GaussianModel.from_scene(random_scene(200, seed=9)).requires_grad_(True)
        step = ttrainer.make_train_step(c, ttrainer.default_optimizer(model, 5e-3),
                                        method="plain")
        metrics = [step(model, cam, target) for _ in range(2)]
        return model, [float(m["loss"]) for m in metrics], metrics[-1]["mean_grads"]

    model, losses, mean_grads = steps(cfg)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert bool(torch.isfinite(mean_grads).all()) and mean_grads.any()
    assert bool(model.sh.grad[:, 1:4].any()) == (cfg.sh_degree == 1)
    if cfg.order == "merge":
        key_model, key_losses, _ = steps(cfg.replace(order="key"))
        assert losses == key_losses
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), key_model.parameters()))
    trainer = ttrainer.Trainer(GaussianModel.from_scene(random_scene(200, seed=9)), config=cfg,
                               lr=5e-3)
    assert np.isfinite(trainer.fit([(cam, target)], steps=1)).all()


def _tiny_dataset(root, n_views: int = 2, size: int = 16, split: str = "train"):
    """A NeRF-synthetic layout: transforms_<split>.json and RGB PNG frames
    of a constant colour ramp, cameras on a ring at radius 2.8."""
    import os

    from gaussian_ray_tracing_tpu_torch.utils.image import write_png

    os.makedirs(os.path.join(root, split), exist_ok=True)
    frames = []
    for i in range(n_views):
        a = 2.0 * np.pi * i / n_views
        eye = np.array([2.8 * np.sin(a), 0.3, 2.8 * np.cos(a)])
        z = eye / np.linalg.norm(eye)  # the camera looks down -z
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
        img = np.full((size, size, 3), 0.2 + 0.3 * i / n_views, np.float32)
        write_png(os.path.join(root, split, f"r_{i}.png"), img)
        frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": 0.7854, "frames": frames}, f)
    return str(root)


@pytest.mark.parametrize("flags", [["--densify"], ["--dataset", "nowhere"],
                                   ["--checkpoint-dir", "nowhere"], ["--order", "window"],
                                   ["--sh-degree", "1"]])
def test_cli_fit_refuses_unported_flags(flags, tmp_path, capsys):
    """The flags cli fit once refused now run: --densify (every step from
    step 1, zero threshold) grows the population, --dataset fits a tiny
    NeRF-synthetic layout, --checkpoint-dir leaves the final step's
    checkpoint, and window order and SH 1 train."""
    flags = list(flags)
    if "--dataset" in flags:
        flags[1] = _tiny_dataset(tmp_path / "data")
    if "--checkpoint-dir" in flags:
        flags[1] = str(tmp_path / "ck")
    if "--densify" in flags:
        flags += ["--densify-from", "1", "--densify-every", "1", "--densify-until", "3",
                  "--densify-grad-threshold", "0", "--capacity", "200"]
    cli.main(["fit", "--synthetic", "300", "--fit-gaussians", "100", "--width", "16",
              "--height", "16", "--steps", "3", "--device", "cpu", *flags])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"])
    assert res["steps_run"] == 3
    if "--densify" in flags:
        assert res["alive"] > 100
    if "--dataset" in flags:
        assert res["views"] == 2 and res["dataset"] == flags[1]
    if "--checkpoint-dir" in flags:
        assert ttrainer.checkpoint_steps(flags[1]) == [3]


def test_cli_fit_writes_ply(tmp_path, capsys):
    out = tmp_path / "fit.ply"
    cli.main(["fit", "--synthetic", "500", "--fit-gaussians", "300", "--width", "48",
              "--height", "32", "--steps", "3", "--device", "cpu", "-o", str(out)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"])
    assert res["steps"] == 3 and res["out"] == str(out)
    back = j_load_ply(str(out))
    assert back.num_active == 300 and np.isfinite(np.asarray(back.means)).all()
