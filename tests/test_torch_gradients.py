"""Gradients of the port: every test of tests/test_gradients.py on the
port's oracle and tiled march (torch autograd), the tiled march's autograd
against the JAX package's jax.grad of render_tiled, and the port's
hand-written backward (K3's plain version) against the tiled march's
autograd (tests/test_pallas.py:239-273).

Bars: finite differences at rtol 0.05, atol 1e-4, and tiled against
oracle gradients at 2e-2 of the largest entry (tests/test_gradients.py);
autograd against jax.grad and K3 against autograd at 1e-3 of the
largest entry of each field (test_pallas.py:268-273). Against jax.grad
the march rounds as XLA does (xla_rounding); K3 is held against the
default per-operation rounding, which is its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JModel
from gaussian_ray_tracing_tpu.models.tiled import render_tiled as j_render_tiled
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle, render_rays_oracle
from gaussian_ray_tracing_tpu_torch.models.renderer import render_diff
from gaussian_ray_tracing_tpu_torch.models.tiled import render_tiled
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

torch.set_num_threads(1)
CFG = RenderConfig(hit_multiplicity=1)
# tests/test_pallas.py's kernel-vs-tiled config, key order
KEY = dict(hit_multiplicity=1, order="key", max_per_tile=4096, chunk_skip_transmittance=1e-3)


def small_model(n=24, seed=11) -> GaussianModel:
    scene = random_scene(n, seed=seed, extent=0.8, mean_scale=0.15, pad_to=n,
                         density_scaling=False)
    return GaussianModel.from_scene(scene)


def ray_loss(model: GaussianModel, cfg=CFG) -> torch.Tensor:
    origins = torch.tensor([[0.0, 0.0, 3.0], [0.3, 0.1, 3.0], [-0.2, 0.2, 3.0]])
    dirs = torch.tensor([[0.0, 0.0, -1.0], [-0.05, 0.0, -1.0], [0.05, -0.05, -1.0]])
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    rgb, density, _ = render_rays_oracle(model.activate(), origins, dirs, cfg, ray_chunk=4)
    # weighted pixel loss exercising both colour and alpha paths
    return torch.sum(rgb * torch.tensor([[0.3, 0.5, 0.2]])) + 0.25 * torch.sum(density)


def grads(loss_fn, model: GaussianModel) -> dict:
    model.requires_grad_(True)
    loss_fn(model).backward()
    return {f: getattr(model, f).grad.numpy().astype(np.float64) for f in FIELDS}


def replaced(model: GaussianModel, field: str, value) -> GaussianModel:
    return dataclasses.replace(model, **{field: torch.tensor(value, dtype=torch.float32)})


def finite_difference(loss_fn, model, field, coord, eps: float) -> float:
    base = getattr(model, field).detach().numpy().astype(np.float64)
    delta = np.zeros_like(base)
    delta[coord] = eps
    with torch.no_grad():
        up = float(loss_fn(replaced(model, field, base + delta)))
        dn = float(loss_fn(replaced(model, field, base - delta)))
    return (up - dn) / (2 * eps)


@pytest.mark.parametrize("field", list(FIELDS))
def test_grad_vs_finite_difference(field):
    """The oracle's autograd at the four largest-gradient coordinates."""
    model = small_model()
    g = grads(ray_loss, model)[field]
    flat = np.abs(g).ravel()
    for idx in np.argsort(flat)[-4:]:
        if flat[idx] < 1e-8:
            continue
        coord = np.unravel_index(idx, g.shape)
        fd = finite_difference(ray_loss, model, field, coord, 3e-4)
        assert np.isclose(fd, g[coord], rtol=0.05, atol=1e-4), \
            f"{field}{coord}: fd={fd:.6g} grad={g[coord]:.6g}"


def test_grad_multiplicity2():
    cfg = RenderConfig(hit_multiplicity=2)
    model = small_model()
    g = grads(lambda m: ray_loss(m, cfg), model)["raw_opacities"]
    idx = (int(np.argmax(np.abs(g))),)
    fd = finite_difference(lambda m: ray_loss(m, cfg), model, "raw_opacities", idx, 3e-4)
    assert np.isclose(fd, g[idx], rtol=0.05, atol=1e-4)


def test_tiled_grads_match_oracle_grads():
    """Gradients through the tiled march agree with the oracle's."""
    cam = Camera.create(eye=(0, 0, 3), lookat=(0, 0, 0), width=32, height=32)
    gt = grads(lambda m: torch.mean(render_tiled(m.activate(), cam, CFG)["rgb"] ** 2),
               small_model(n=64, seed=13))
    go = grads(lambda m: torch.mean(render_oracle(m.activate(), cam, CFG)["rgb"] ** 2),
               small_model(n=64, seed=13))
    for f in FIELDS:
        denom = max(np.abs(go[f]).max(), 1e-8)
        np.testing.assert_allclose(gt[f] / denom, go[f] / denom, atol=2e-2, err_msg=f)


def test_model_roundtrip():
    scene = random_scene(50, seed=1)
    back = GaussianModel.from_scene(scene).activate()
    np.testing.assert_allclose(back.scales.numpy(), scene.scales.numpy(), rtol=1e-5)
    np.testing.assert_allclose(back.opacities.numpy(), scene.opacities.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(back.quats.numpy(), scene.quats.numpy(), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def model500():
    """tests/test_pallas.py:244-250's model, camera and target."""
    jm = JModel.from_scene(j_random_scene(500, seed=6))
    kw = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=32)
    return jm, kw


def _tiled_loss(cam, cfg, **kw):
    return lambda m: torch.mean((render_tiled(m.activate(), cam, cfg, pair_capacity=100_000,
                                              **kw)["rgb"] - 0.3) ** 2)


def _port(jm) -> GaussianModel:
    return GaussianModel.from_numpy({f: np.asarray(getattr(jm, f)) for f in FIELDS},
                                    jm.num_active)


def test_tiled_autograd_matches_jax_grad(model500):
    jm, kw = model500
    target = jnp.full((32, 64, 3), 0.3, jnp.float32)

    def loss(m):
        out = j_render_tiled(m.activate(), JCamera.create(**kw), JConfig(**KEY),
                             pair_capacity=100_000)
        return jnp.mean((out["rgb"] - target) ** 2)

    want = jax.grad(loss)(jm)
    got = grads(_tiled_loss(Camera.create(**kw), RenderConfig(**KEY), xla_rounding=True),
                _port(jm))
    for f in FIELDS:
        b = np.asarray(getattr(want, f))
        assert np.isfinite(got[f]).all(), f
        assert np.abs(got[f] - b).max() / (np.abs(b).max() + 1e-12) < 1e-3, f


@pytest.mark.parametrize("sh", [0, 3])
def test_plain_k3_matches_tiled_autograd(model500, sh):
    """render_diff's hand-written backward (K3's plain version, key order)
    against autograd of the tiled march on the same forward."""
    jm, kw = model500
    cam, cfg = Camera.create(**kw), RenderConfig(**KEY, sh_degree=sh)
    want = grads(_tiled_loss(cam, cfg), _port(jm))
    got = grads(lambda m: torch.mean((render_diff(m.activate(), cam, cfg, method="plain",
                                                  pair_capacity=100_000)["rgb"] - 0.3) ** 2),
                _port(jm))
    for f in FIELDS:
        assert np.isfinite(got[f]).all() and np.isfinite(want[f]).all(), f
        assert np.abs(got[f] - want[f]).max() / (np.abs(want[f]).max() + 1e-12) < 1e-3, f
