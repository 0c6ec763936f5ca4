"""The port's density control (train/density.py), optimizer moment reset
and density-driven trainer against the JAX package's, on the CPU.

One set of raw weights and one set of gradient statistics feed both
packages. `densify_and_prune_core` is fed JAX's own normal draws
(jax.random.normal of the round's key and of fold_in(key, 1)), so the
deterministic fields -- liveness, touched slots, raw opacities, quats, SH
and log-scales -- are compared exactly; the means of split children and
re-seeded parents go through an (N, 3, 3) x (N, 3) product that XLA and
torch sum in their own order, and are compared at 1e-6 relative to the
largest mean. DensityState.accumulate's depth/focal scaling is compared at
rtol 1e-6 (float32 norms rounded in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JModel
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu.train import density as jd
from gaussian_ray_tracing_tpu.train.trainer import gaussian_optimizer as j_gaussian_optimizer
from gaussian_ray_tracing_tpu.train.trainer import reset_opt_moments as j_reset_opt_moments
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.renderer import render
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.train import density as td
from gaussian_ray_tracing_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)


def _padded_model(n_live=64, pad=64, seed=0):
    """The JAX suite's padded model (tests/test_density.py:23-37)."""
    model = JModel.from_scene(j_random_scene(n_live, seed=seed, pad_to=n_live))
    return JModel(
        means=jnp.pad(model.means, ((0, pad), (0, 0))),
        log_scales=jnp.pad(model.log_scales, ((0, pad), (0, 0))),
        raw_quats=jnp.pad(model.raw_quats, ((0, pad), (0, 0)), constant_values=1.0),
        raw_opacities=jnp.concatenate([model.raw_opacities, jnp.full((pad,), jd.DEAD_LOGIT)]),
        sh=jnp.pad(model.sh, ((0, pad), (0, 0), (0, 0))),
        num_active=0,
    )


def _port(jmodel) -> GaussianModel:
    return GaussianModel.from_numpy({k: np.asarray(getattr(jmodel, k)) for k in FIELDS},
                                    jmodel.num_active)


def _both_rounds(jmodel, grads: np.ndarray, cfg_kw: dict, seed: int = 0):
    """One densify round in each package from the same model, statistics
    and normal draws. Returns (JAX model, JAX touched, port model, port
    touched) as numpy."""
    n = jmodel.means.shape[0]
    jstate = jd.DensityState.create(n).accumulate(jnp.asarray(grads))
    key = jax.random.PRNGKey(seed)
    m2, touched = jd.densify_and_prune(jmodel, jstate, key, jd.DensityConfig(**cfg_kw),
                                       jnp.float32(1.0))
    eps = torch.from_numpy(np.array(jax.random.normal(key, (n, 3), jnp.float32)))
    eps2 = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 1), (n, 3),
                                                         jnp.float32)))
    model = _port(jmodel)
    tstate = td.DensityState.create(n).accumulate(torch.from_numpy(grads))
    t_touched = td.densify_and_prune_core(model, tstate, eps, eps2, td.DensityConfig(**cfg_kw),
                                          1.0)
    return m2, np.asarray(touched), model, t_touched.numpy()


def _assert_same_round(m2, touched, model, t_touched):
    """Deterministic fields exactly; means at 1e-6 of the largest mean."""
    assert np.array_equal(t_touched, touched)
    got = model.to_numpy()
    for k in ("raw_opacities", "raw_quats", "sh", "log_scales"):
        assert np.array_equal(got[k], np.asarray(getattr(m2, k))), k
    want = np.asarray(m2.means)
    assert np.abs(got["means"] - want).max() <= 1e-6 * np.abs(want).max()
    assert td.alive_count(model) == int(jd.alive_count(m2))


def _grads(n: int, rows, value: float = 1.0) -> np.ndarray:
    g = np.zeros((n, 3), np.float32)
    g[rows, 0] = value
    return g


class TestDensify:
    def test_clone_fills_dead_slots(self):
        jmodel = _padded_model()
        out = _both_rounds(jmodel, _grads(128, slice(0, 10)),
                           dict(grad_threshold=0.5, percent_dense=10.0, min_opacity=0.0))
        _assert_same_round(*out)
        _, _, model, touched = out
        assert td.alive_count(model) == 64 + 10
        # clones are verbatim copies of their parents
        new = touched & (model.raw_opacities.numpy() > td.DEAD_LOGIT + 1)
        parents = np.asarray(jmodel.means)[:10]
        for row in model.means.detach().numpy()[new]:
            assert np.any(np.all(np.isclose(parents, row), axis=1))

    def test_split_shrinks_and_perturbs(self):
        jmodel = _padded_model()
        out = _both_rounds(jmodel, _grads(128, slice(0, 5)),
                           dict(grad_threshold=0.5, percent_dense=0.0, min_opacity=0.0))
        _assert_same_round(*out)
        _, _, model, touched = out
        assert td.alive_count(model) == 64 + 5
        ls_old = np.asarray(jmodel.log_scales[:5])
        np.testing.assert_allclose(model.log_scales[:5].numpy(), ls_old - np.log(1.6), rtol=1e-6)
        assert np.all(np.any(model.means[:5].numpy() != np.asarray(jmodel.means[:5]), axis=1))
        assert int(touched.sum()) == 10  # 5 parents + 5 siblings

    def test_prune_and_capacity_exhaustion(self):
        jmodel = _padded_model(n_live=64, pad=4)  # only 4 free slots
        out = _both_rounds(jmodel, np.ones((68, 3), np.float32),
                           dict(grad_threshold=0.5, percent_dense=10.0, min_opacity=0.0))
        _assert_same_round(*out)
        m2, _, model, _ = out
        assert td.alive_count(model) == 64 + 4  # births capped at the 4 dead slots
        assert bool(torch.isfinite(model.means).all())
        # prune everything via an impossible opacity floor
        out = _both_rounds(m2, np.zeros((68, 3), np.float32),
                           dict(grad_threshold=1e9, min_opacity=1.1), seed=1)
        _assert_same_round(*out)
        assert td.alive_count(out[2]) == 0

    def test_births_survive_opacity_floor(self):
        """Births written into dead slots are not re-killed by the prune
        mask (dead slots trivially fail the opacity floor)."""
        jmodel = _padded_model()
        out = _both_rounds(jmodel, _grads(128, slice(0, 10)),
                           dict(grad_threshold=0.5, percent_dense=10.0, min_opacity=5e-3))
        _assert_same_round(*out)
        assert td.alive_count(out[2]) == int(jd.alive_count(jmodel)) + 10

    def test_dead_slots_render_invisible(self):
        model = _port(_padded_model())
        cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=48)
        cfg = RenderConfig(hit_multiplicity=1)
        base = render(model.activate(), cam, cfg)["rgb"]
        with torch.no_grad():
            model.raw_opacities[:32] = td.DEAD_LOGIT  # kill half the live slots
        out = render(model.activate(), cam, cfg)["rgb"]
        assert not torch.allclose(base, out)
        td.reset_opacities(model)  # acts on live slots only
        assert bool(torch.isfinite(render(model.activate(), cam, cfg)["rgb"]).all())
        assert bool((model.raw_opacities[:32] == td.DEAD_LOGIT).all())

    def test_opacity_reset_ceiling(self):
        jmodel = _padded_model()
        model = _port(jmodel)
        td.reset_opacities(model, ceiling=0.01)
        want = np.asarray(jd.reset_opacities(jmodel, ceiling=0.01).raw_opacities)
        assert np.array_equal(model.raw_opacities.numpy(), want)
        assert np.all(torch.sigmoid(model.raw_opacities[:64]).numpy() <= 0.0101)
        assert np.array_equal(model.raw_opacities[64:].numpy(),
                              np.asarray(jmodel.raw_opacities[64:]))


def test_accumulate_scales_by_depth_over_focal_as_jax():
    """Two steps of camera-scaled statistics: grad_accum at rtol 1e-6,
    grad_count exactly."""
    rng = np.random.default_rng(3)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    g1, g2 = (rng.normal(size=(50, 3)).astype(np.float32) for _ in range(2))
    g2[::5] = 0.0  # unobserved slots do not count
    kw = dict(eye=(0.3, 0.4, 2.8), lookat=(0.0, 0.1, 0.0), fov_y_deg=50.0, width=64, height=48)
    js = jd.DensityState.create(50)
    ts = td.DensityState.create(50)
    for g in (g1, g2):
        js = js.accumulate(jnp.asarray(g), camera=JCamera.create(**kw), means=jnp.asarray(means))
        ts = ts.accumulate(torch.from_numpy(g), camera=Camera.create(**kw),
                           means=torch.from_numpy(means))
    np.testing.assert_allclose(ts.grad_accum.numpy(), np.asarray(js.grad_accum), rtol=1e-6)
    assert np.array_equal(ts.grad_count.numpy(), np.asarray(js.grad_count))
    assert float(ts.reset().grad_accum.abs().sum()) == 0.0


def test_wrapper_draws_from_the_generator():
    """densify_and_prune takes its two draws from the generator, in order:
    the same seed gives the core's result on torch.randn draws."""
    jmodel = _padded_model()
    stats = td.DensityState.create(128).accumulate(torch.from_numpy(_grads(128, slice(0, 8))))
    cfg = td.DensityConfig(grad_threshold=0.5, percent_dense=0.0, min_opacity=0.0)
    a, b = _port(jmodel), _port(jmodel)
    ta = td.densify_and_prune(a, stats, torch.Generator().manual_seed(5), cfg, 1.0)
    gen = torch.Generator().manual_seed(5)
    eps, eps2 = torch.randn((128, 3), generator=gen), torch.randn((128, 3), generator=gen)
    tb = td.densify_and_prune_core(b, stats, eps, eps2, cfg, 1.0)
    assert torch.equal(ta, tb) and all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                                          b.parameters()))


def test_per_group_rates_and_moment_reset():
    """The port of TestGaussianOptimizer: one GaussianAdam step on unit
    gradients moves means < 1e-2, opacities > 1e-3, the higher SH bands at
    < 0.1 of the DC step; reset_opt_moments zeroes the touched slot's rows
    of every moment, as JAX's does on optax's state, and leaves the step."""
    jmodel = _padded_model()
    model = _port(jmodel).requires_grad_(True)
    opt = ttrainer.gaussian_optimizer(model, scene_extent=2.0, total_steps=100)
    before = [p.detach().clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    upd = {k: (p.detach() - b) for k, p, b in zip(FIELDS, model.parameters(), before)}
    assert float(upd["means"].abs().max()) < 1e-2
    assert float(upd["raw_opacities"].abs().max()) > 1e-3
    assert float(upd["sh"][:, 1:].abs().max() / upd["sh"][:, :1].abs().max()) < 0.1

    touched = torch.zeros(128, dtype=torch.bool)
    touched[3] = True
    ttrainer.reset_opt_moments(opt, touched)
    moments = [x for st in opt.state.values() for k, x in st.items() if k != "step"]
    assert len(moments) == 2 * len(FIELDS)
    for x in moments:
        assert float(x[3].abs().max()) == 0.0 and float(x[4].abs().max()) > 0.0
    assert all(int(st["step"]) == 1 for st in opt.state.values())

    tx = j_gaussian_optimizer(scene_extent=2.0, total_steps=100)
    state = tx.init(jmodel)
    _, state = tx.update(jax.tree_util.tree_map(jnp.ones_like, jmodel), state, jmodel)
    jstate = j_reset_opt_moments(state, jnp.asarray(touched.numpy()))
    leaves = [x for x in jax.tree_util.tree_leaves(jstate)
              if x.ndim >= 1 and x.shape[0] == 128 and jnp.issubdtype(x.dtype, jnp.floating)]
    assert len(leaves) == len(moments)
    for x in leaves:
        assert float(jnp.abs(x[3]).max()) == 0.0


def test_fit_with_density_control():
    """The port of TestTrainerDensity: a zero threshold densifies every
    round, the population grows, losses stay finite; the rounds fire at the
    JAX schedule's steps (4 and 8 of 10)."""
    cfg = RenderConfig(hit_multiplicity=1, order="key")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=48, height=32)
    target = render(random_scene(300, seed=0), cam, cfg)["rgb"]
    init = random_scene(100, seed=1, pad_to=256)
    density = td.DensityConfig(densify_from_step=2, densify_until_step=100, densify_every=4,
                               opacity_reset_every=0, grad_threshold=0.0, min_opacity=0.0)
    tr = ttrainer.Trainer(GaussianModel.from_scene(init), config=cfg, lr=5e-3, density=density)
    rounds = []
    original = tr._density_round
    tr._density_round = lambda step: rounds.append(step) or original(step)
    before = tr.alive()
    losses = tr.fit([(cam, target)], steps=10)
    assert rounds == [4, 8]
    assert tr.alive() > before
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert tr._next_event(0, 10) == 4 and tr._next_event(8, 10) == 10


def test_to_ply_keeps_densified_slots_beyond_num_active(tmp_path):
    """Births scattered into dead slots anywhere in the static capacity are
    saved, as the JAX package's to_ply saves them."""
    from gaussian_ray_tracing_tpu.scene.ply import load_ply as j_load_ply

    jmodel = JModel.from_scene(j_random_scene(64, seed=1, pad_to=256))
    raw_op = np.array(jmodel.raw_opacities)
    raw_op[200:210] = 0.5
    jmodel = dataclasses.replace(jmodel, raw_opacities=jnp.asarray(raw_op))
    model = _port(jmodel)
    path = str(tmp_path / "densified.ply")
    model.to_ply(path)
    reloaded = j_load_ply(path)
    assert reloaded.num_active == jmodel.num_active + 10
    jpath = str(tmp_path / "densified_jax.ply")
    jmodel.to_ply(jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()


@pytest.mark.parametrize("n_dead", [0, 3])
def test_round_with_no_room_or_no_heat_changes_nothing_but_prunes(n_dead):
    """No dead slot (or nothing hot): no birth; prunes still apply."""
    jmodel = _padded_model(n_live=64, pad=n_dead)
    n = 64 + n_dead
    out = _both_rounds(jmodel, _grads(n, slice(0, 10)) if n_dead == 0 else np.zeros((n, 3),
                                                                                     np.float32),
                       dict(grad_threshold=0.5, percent_dense=10.0, min_opacity=0.05))
    _assert_same_round(*out)
    m2, touched, model, _ = out
    assert td.alive_count(model) <= 64
