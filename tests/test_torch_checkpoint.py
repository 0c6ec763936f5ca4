"""Training checkpoints with resume (Trainer.save_checkpoint /
restore_checkpoint), ports of tests/test_checkpoint.py, on the CPU: the
params, the optimizer moments and the step round-trip exactly; a resumed
run equals an uninterrupted one bit for bit (the plain versions are
deterministic on the CPU); fit(checkpoint_dir) saves where the JAX
package's segments end."""

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.scene.ply import load_ply as j_load_ply
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
from gaussian_ray_tracing_tpu_torch.models.renderer import render
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.train import trainer as ttrainer
from gaussian_ray_tracing_tpu_torch.train.density import DensityConfig
from gaussian_ray_tracing_tpu_torch.train.losses import dssim_l1_loss

torch.set_num_threads(1)
CFG = RenderConfig(hit_multiplicity=1, order="key")


def _view(seed: int, n: int = 300, size: int = 32):
    cam = Camera.create(eye=(0, 0, 2.5), lookat=(0, 0, 0), width=size, height=size)
    return cam, render(random_scene(n, seed=seed), cam, CFG)["rgb"]


def _trainer(seed: int = 1, n: int = 300, config=CFG, **kw):
    return ttrainer.Trainer(GaussianModel.from_scene(random_scene(n, seed=seed)), config=config,
                            **kw)


def test_train_state_roundtrip(tmp_path):
    tr = _trainer()
    view = _view(2)
    tr.fit([view], steps=3)
    tr.save_checkpoint(str(tmp_path))
    assert ttrainer.checkpoint_steps(str(tmp_path)) == [3]
    back = _trainer(seed=9)
    back.restore_checkpoint(str(tmp_path))
    assert back.steps_done == 3
    for a, b in zip(back.model.parameters(), tr.model.parameters()):
        assert torch.equal(a, b)
    # adam moments restored too
    for p, q in zip(back.model.parameters(), tr.model.parameters()):
        sa, sb = back.optimizer.state[p], tr.optimizer.state[q]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert int(sa["step"]) == int(sb["step"]) == 3


def test_ply_scene_roundtrip(tmp_path):
    model = GaussianModel.from_scene(random_scene(200, seed=4))
    path = str(tmp_path / "scene.ply")
    model.to_ply(path)
    scene = j_load_ply(path)
    np.testing.assert_allclose(np.asarray(scene.means)[:200], model.means.numpy()[:200],
                               atol=1e-6)


def test_fit_is_resume_aware(tmp_path):
    """`steps` is the total schedule: a trainer restored at step k runs
    exactly steps - k more (none when k == steps)."""
    tr = _trainer(seed=4, n=200)
    view = _view(5, n=200)
    tr.fit([view], steps=4)
    tr.save_checkpoint(str(tmp_path))
    tr2 = _trainer(seed=4, n=200)
    tr2.restore_checkpoint(str(tmp_path))
    assert tr2.steps_done == 4
    assert tr2.fit([view], steps=4) == [] and tr2.steps_done == 4
    assert len(tr2.fit([view], steps=6)) == 2 and tr2.steps_done == 6


@pytest.mark.parametrize("optimizer", ["adam", "3dgs"])
def test_resumed_run_equals_uninterrupted(tmp_path, optimizer):
    """4 steps straight vs 2 steps, a checkpoint, a fresh trainer restored
    from it and 2 more: the same losses and the same weights bit for bit
    (3dgs: the per-group Adam whose means-rate schedule count is restored
    with it, and dssim_l1)."""
    views = [_view(2), _view(3)]

    def make():
        model = GaussianModel.from_scene(random_scene(300, seed=1))
        opt = (ttrainer.gaussian_optimizer(model, scene_extent=1.5, total_steps=4)
               if optimizer == "3dgs" else None)
        return ttrainer.Trainer(model, config=CFG, optimizer=opt, loss_fn=dssim_l1_loss)

    straight = make()
    losses = straight.fit(views, steps=4)
    first = make()
    head = first.fit(views, steps=2)
    first.save_checkpoint(str(tmp_path))
    resumed = make()
    resumed.restore_checkpoint(str(tmp_path))
    tail = resumed.fit(views, steps=4)
    assert head + tail == losses
    for a, b in zip(resumed.model.parameters(), straight.model.parameters()):
        assert torch.equal(a, b)
    if optimizer == "3dgs":
        assert resumed.optimizer.count == straight.optimizer.count == 4


def test_fit_checkpoints_at_segment_ends_and_restores_the_newest(tmp_path, monkeypatch):
    """With a density schedule (rounds at 4 and 8 of 10) fit saves after
    each round while steps remain; without one, every _MAX_SEGMENT steps
    (512; 3 here). restore_checkpoint takes the newest step unless told."""
    view = _view(2)
    density = DensityConfig(densify_from_step=2, densify_until_step=100, densify_every=4,
                            opacity_reset_every=0, grad_threshold=0.0, min_opacity=0.0)
    tr = ttrainer.Trainer(GaussianModel.from_scene(random_scene(100, seed=1, pad_to=256)),
                          config=CFG, lr=5e-3, density=density)
    d = str(tmp_path / "density")
    tr.fit([view], steps=10, checkpoint_dir=d)
    assert sorted(ttrainer.checkpoint_steps(d)) == [4, 8]
    monkeypatch.setattr(ttrainer, "_MAX_SEGMENT", 3)
    tr = _trainer()
    d = str(tmp_path / "segments")
    tr.fit([view], steps=7, checkpoint_dir=d)
    assert sorted(ttrainer.checkpoint_steps(d)) == [3, 6]
    back = _trainer(seed=9)
    back.restore_checkpoint(d)
    assert back.steps_done == 6
    back.restore_checkpoint(d, step=3)
    assert back.steps_done == 3
    assert ttrainer.checkpoint_steps(str(tmp_path / "missing")) == []
