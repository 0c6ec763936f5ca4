"""The port's losses, optimizers, trainable model and PLY writer against
the JAX package: losses at rtol 1e-5 and the dssim_l1 gradient at rtol
1e-4; Adam updates of each optimizer against optax at rtol 1e-5 and the
3DGS means rate against optax.exponential_decay; the model's activations
at rtol 1e-6; save_ply read back by the JAX reader.

optax forms Adam's bias correction 1 - 0.999^t in float32, which loses
five digits (1.3e-5 relative at t = 1, 6e-6 on the update after the square
root); torch.optim.Adam forms it in double. Parameters are therefore held
at rtol 1e-5 plus 1e-5 of the field's largest update."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JModel
from gaussian_ray_tracing_tpu.scene.ply import load_ply as j_load_ply
from gaussian_ray_tracing_tpu.scene.ply import read_ply_raw as j_read_ply_raw
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu.train import losses as jlosses
from gaussian_ray_tracing_tpu.train import trainer as jtrainer
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply, save_ply
from gaussian_ray_tracing_tpu_torch.train import losses as tlosses
from gaussian_ray_tracing_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)
LOSSES = ["l1_loss", "l2_loss", "ssim", "dssim_l1_loss", "psnr_loss"]


def _images(kind: str):
    rng = np.random.default_rng(3)
    if kind == "noise":
        a, b = rng.uniform(size=(2, 40, 48, 3)).astype(np.float32)
    else:  # smooth renders: SSIM's variances cancel by orders of magnitude
        y, x = np.mgrid[0:40, 0:48].astype(np.float32) / 48.0
        base = 0.4 + 0.2 * np.sin(3 * x + 2 * y)[..., None] * np.array([1.0, 0.8, 0.6])
        a = base.astype(np.float32)
        b = (base + 0.01 * rng.normal(size=base.shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(name, kind):
    a, b = _images(kind)
    want = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tlosses, name)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_dssim_l1_gradient_matches_jax(kind):
    a, b = _images(kind)
    want = np.asarray(jax.grad(jlosses.dssim_l1_loss)(jnp.asarray(a), jnp.asarray(b)))
    x = torch.from_numpy(a).requires_grad_(True)
    tlosses.dssim_l1_loss(x, torch.from_numpy(b)).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _fixed_model_and_grads():
    rng = np.random.default_rng(5)
    shapes = dict(means=(64, 3), log_scales=(64, 3), raw_quats=(64, 4), raw_opacities=(64,),
                  sh=(64, 4, 3))
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    return params, grads


def _jax_updates(tx, params, grads, steps):
    jp = JModel(**{k: jnp.asarray(v) for k, v in params.items()}, num_active=64)
    jg = JModel(**{k: jnp.asarray(v) for k, v in grads.items()}, num_active=64)
    state = tx.init(jp)
    for _ in range(steps):
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
    return jp


def _torch_updates(make_opt, params, grads, steps):
    model = GaussianModel.from_numpy(params, 64).requires_grad_(True)
    opt = make_opt(model)
    for _ in range(steps):
        for k in FIELDS:
            getattr(model, k).grad = torch.from_numpy(grads[k].copy())
        opt.step()
    return model


@pytest.mark.parametrize("which", ["default", "3dgs"])
def test_optimizer_updates_match_optax(which):
    """Two updates on fixed gradients: Adam moments, bias correction, the
    per-field 3DGS rates, the decayed means rate and the 1/20 higher-band
    SH scaling all show in the parameters."""
    params, grads = _fixed_model_and_grads()
    if which == "default":
        tx = jtrainer.default_optimizer(3e-3)
        make = lambda m: ttrainer.default_optimizer(m, 3e-3)
    else:
        tx = jtrainer.gaussian_optimizer(scene_extent=2.0, total_steps=4, lr_scale=3.0)
        make = lambda m: ttrainer.gaussian_optimizer(m, scene_extent=2.0, total_steps=4,
                                                     lr_scale=3.0)
    want = _jax_updates(tx, params, grads, 2)
    got = _torch_updates(make, params, grads, 2)
    for k in FIELDS:
        b = np.asarray(getattr(want, k))
        step = np.abs(b - params[k]).max()
        assert step > 0, k
        np.testing.assert_allclose(getattr(got, k).detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * step, err_msg=k)


def test_gaussian_optimizer_means_rate_matches_exponential_decay():
    total = 1000
    sched = optax.exponential_decay(1.6e-4 * 2.5 * 1.5, transition_steps=total, decay_rate=0.01)
    params, _ = _fixed_model_and_grads()
    opt = ttrainer.gaussian_optimizer(GaussianModel.from_numpy(params, 64), scene_extent=2.5,
                                      total_steps=total, lr_scale=1.5)
    for step in (0, total // 2, total):
        np.testing.assert_allclose(opt.means_lr(step), float(sched(step)), rtol=1e-6)


def test_model_activations_match_jax():
    js = j_random_scene(300, seed=2)
    jm = JModel.from_scene(js)
    tm = GaussianModel.from_scene(GaussianScene.from_numpy(
        {k: np.asarray(getattr(js, k)) for k in ("means", "scales", "quats", "opacities", "sh")},
        js.num_active))
    assert tm.num_active == jm.num_active
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    back = GaussianModel.from_numpy(jm_arrays := {k: np.asarray(getattr(jm, k)) for k in FIELDS},
                                    jm.num_active)
    assert all(np.array_equal(back.to_numpy()[k], jm_arrays[k]) for k in FIELDS)
    ja, ta = jm.activate(), back.activate()
    for k in ("means", "scales", "quats", "opacities", "sh"):
        np.testing.assert_allclose(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_save_ply_round_trips_through_jax_reader(tmp_path):
    jm = JModel.from_scene(j_random_scene(300, seed=4))
    arrays = {k: np.asarray(getattr(jm, k)) for k in FIELDS}
    model = GaussianModel.from_numpy(arrays, jm.num_active)
    path = str(tmp_path / "m.ply")
    model.to_ply(path)  # the first num_active slots: padding is dead
    cols = j_read_ply_raw(path)
    assert cols["x"].shape == (300,)
    np.testing.assert_array_equal(cols["opacity"], arrays["raw_opacities"][:300])
    np.testing.assert_array_equal(cols["rot_3"], arrays["raw_quats"][:300, 3])
    np.testing.assert_array_equal(cols["f_rest_44"], arrays["sh"][:300, 15, 2])
    js = j_load_ply(path)
    ts = load_ply(path)
    np.testing.assert_array_equal(ts.means.numpy(), np.asarray(js.means))
    np.testing.assert_allclose(ts.scales.numpy(), np.asarray(js.scales), rtol=1e-6)
    save_ply(str(tmp_path / "raw.ply"), *(arrays[k][:5] for k in FIELDS))
    assert j_read_ply_raw(str(tmp_path / "raw.ply"))["x"].shape == (5,)
