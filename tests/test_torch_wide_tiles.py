"""Training on tiles of 512 and 1024 rays (32x16 and 32x32) against the JAX
package on the CPU, where JAX trains any tile size: the port's plain
`render_diff` (K1 with saved carries, K3) against `render_pallas_diff`
(Pallas in interpret mode) in key and window order, the per-ray-origin
quad `march_stream_diff` against JAX's at 1024 rays a tile, and the
trainer at 32x32, which refused such tiles before.

Setup: `random_scene(300, seed=3)` at 64x64, `hit_multiplicity=1`, the JAX
suite's training config (key order's chunk skip 1e-3), window order at
chunk 32; L2 to a flat target. Bars are those of
tests/test_torch_train_modes.py and tests/test_torch_train.py: the loss at
rtol 1e-4, per raw field max|a - b| / max|b| <= 1e-3, rgb PSNR >= 70 dB
and max abs <= 1e-2. Both sides leave the boundary rays out of the loss (a
gaussian's peak alpha within ALPHA_EPS of alpha_min, in float64: XLA's
CPU backend contracts a + b*c into FMAs where the port rounds each
operation, so the gate may pass on one side only). The per-ray-origin case
uses tests/test_torch_per_ray_origin.py's extras and bars on one stream of
two 1024-ray tiles, the forward's tail as FWD_TAIL_* say."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays as j_generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.gaussian_model import GaussianModel as JModel
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream, render_pallas_diff
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_bwd, pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.renderer import render_diff
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.ops.response import canonical_frames, max_response
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.train import trainer as ttrainer
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
KW = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3)
EYE = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0))
SIZE = 64
ALPHA_EPS = 1e-4  # boundary rays: |peak alpha / alpha_min - 1| below this
# the per-ray-origin case's forward: atol 2e-5 on all but FWD_TAIL_FRAC of
# the values and FWD_TAIL_ABS on those. The quad expansion's sums round
# differently under XLA's FMAs; on this 64x32 stream the same bars hold
# 16x16 tiles no tighter (measured: t_final 6.1e-5 max, 0.64% above 2e-5 at
# 16x16; 5.8e-5, 0.49% at 32x32), so they measure the frame, not the tile.
FWD_TAIL_FRAC, FWD_TAIL_ABS = 0.01, 1e-4


def _boundary_rays(scene, origins, dirs, alpha_min: float) -> np.ndarray:
    """(...) bool: the rays on which some gaussian of the (JAX) scene peaks
    within ALPHA_EPS of alpha_min, from each ray's origin, in float64."""
    f64 = lambda x: torch.from_numpy(np.asarray(x, np.float64)[: scene.num_active])
    means, ops = f64(scene.means), f64(scene.opacities)
    M = canonical_frames(f64(scene.scales), f64(scene.quats))
    shape = np.shape(dirs)[:-1]
    o = torch.from_numpy(np.broadcast_to(np.asarray(origins, np.float64),
                                         np.shape(dirs)).reshape(-1, 1, 3))
    d = torch.from_numpy(np.asarray(dirs, np.float64).reshape(-1, 1, 3))
    near = [(torch.clamp(max_response(means, M, oo, dd)[0] * ops, max=0.99) / alpha_min - 1.0)
            .abs().lt(ALPHA_EPS).any(dim=1) for oo, dd in zip(o.split(1024), d.split(1024))]
    return torch.cat(near).reshape(shape).numpy()


@functools.lru_cache(maxsize=None)
def _weights():
    jmodel = JModel.from_scene(j_random_scene(300, seed=3))
    keep = ~_boundary_rays(jmodel.activate(), np.array(EYE["eye"]),
                           generate_rays(Camera.create(width=SIZE, height=SIZE, **EYE),
                                         RenderConfig())[1].numpy(), 0.01)
    assert keep.sum() >= 0.995 * keep.size  # a few rays, never a region
    return jmodel, keep[..., None].astype(np.float32)


@pytest.mark.parametrize("order", ["key", "window"])
@pytest.mark.parametrize("tile_h", [16, 32])
def test_wide_tile_training_matches_render_pallas_diff(order, tile_h):
    """render_diff's value and gradient at 32 x tile_h rays a tile against
    render_pallas_diff's at the same tiles."""
    kw = {**KW, "order": order, "tile_w": 32, "tile_h": tile_h,
          "march_chunk": 32 if order == "window" else 256}
    jmodel, keep = _weights()
    target = np.full((SIZE, SIZE, 3), 0.3, np.float32)
    norm = 3.0 * keep.sum()

    def loss_pallas(m):
        out = render_pallas_diff(m.activate(), JCamera.create(width=SIZE, height=SIZE, **EYE),
                                 JConfig(**kw), pair_capacity=100_000)
        return jnp.sum(keep * (out["rgb"] - target) ** 2) / norm, out["rgb"]

    (j_loss, j_rgb), j_grads = jax.value_and_grad(loss_pallas, has_aux=True)(jmodel)
    model = GaussianModel.from_numpy({k: np.asarray(getattr(jmodel, k)) for k in FIELDS},
                                     jmodel.num_active).requires_grad_(True)
    out = render_diff(model.activate(), Camera.create(width=SIZE, height=SIZE, **EYE),
                      RenderConfig(**kw), method="plain", pair_capacity=100_000)
    rgb = out["rgb"].detach().numpy()
    assert psnr(rgb * keep, np.asarray(j_rgb) * keep) >= 70.0
    assert np.abs(rgb - np.asarray(j_rgb)).max(axis=-1)[keep[..., 0] > 0].max() <= 1e-2
    assert float(out["alpha"].max()) > 0.5  # the frame really composites
    loss = torch.sum(torch.from_numpy(keep) * (out["rgb"] - torch.from_numpy(target)) ** 2) / norm
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    for f in FIELDS:
        a = getattr(model, f).grad.numpy()
        b = np.asarray(getattr(j_grads, f))
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) <= 1e-3, f


def test_per_ray_origin_quad_training_at_1024_rays_matches_jax():
    """march_stream_diff with per-ray origins, windows and carry-in on the
    quad response in key order, two tiles of 1024 rays (64x32, 32x32
    tiles, random_scene(300, seed=6), chunk 32, min_transmittance 1e-8):
    forward, saved carries and d(pair_feats) against JAX's kernels."""
    C = 32
    kw = dict(KW, march_chunk=C, min_transmittance=1e-8, order="key", tile_w=32, tile_h=32)
    scene = j_random_scene(300, seed=6)
    cam = JCamera.create(width=64, height=32, **EYE)
    jcfg = JConfig(**kw)
    stream, pair_feats, _, _ = prepare_pair_stream(scene, cam, jcfg, 50_000, C)
    dirs_t = np.array(tile_rays(j_generate_rays(cam, jcfg)[1], 32, 32))
    T, R = dirs_t.shape[:2]
    assert R == 1024
    rng = np.random.default_rng(3)
    f32 = lambda x: np.asarray(x, np.float32)
    eye = np.array(cam.eye, np.float32)
    ext = dict(origins_t=f32(eye + 0.05 * rng.normal(size=(T, R, 3))),
               t_lo=f32(0.05 + 0.05 * rng.uniform(size=(T, R))),
               t_hi=f32(3.0 + rng.uniform(size=(T, R))),
               t0=f32(0.6 + 0.4 * rng.uniform(size=(T, R))))
    keep = ~_boundary_rays(scene, ext["origins_t"], dirs_t, jcfg.alpha_min)
    assert keep.sum() >= 0.99 * keep.size
    d_rgb = f32(rng.normal(size=(T, R, 3)) * keep[..., None])
    d_tfinal = f32(rng.normal(size=(T, R)) * keep)
    starts, feats = np.array(stream.starts), np.array(pair_feats)

    j_rgb, j_t, j_tin, j_base = pallas_march_stream(
        starts, eye, feats, dirs_t, jcfg, n_tiles=T, rays_per_tile=R, chunk=C, interpret=True,
        save_tin=True, quad=True, **ext)
    j_dfeats = np.asarray(pallas_march_bwd(
        starts, eye, feats, dirs_t, j_tin, j_base, d_rgb, d_tfinal, jcfg, n_tiles=T,
        rays_per_tile=R, chunk=C, interpret=True, origins_t=ext["origins_t"],
        t_lo=ext["t_lo"], t_hi=ext["t_hi"]))

    t = lambda x: torch.from_numpy(np.array(x))
    cfg = RenderConfig(**kw)
    text = {k: t(v) for k, v in ext.items()}
    rows = tmarch.train_features(t(feats))
    rgb, t_final, tin, base = tmarch.march(t(starts), rows, t(dirs_t), cfg, C, save_tin=True,
                                           quad=True, **text)
    for a, b in ((rgb, j_rgb), (t_final, j_t)):
        err = np.abs(a.numpy() - np.asarray(b))[keep]
        assert (err > 2e-5).mean() <= FWD_TAIL_FRAC and err.max() <= FWD_TAIL_ABS
    assert np.array_equal(base.numpy(), np.asarray(j_base))
    n = int(base[-1])
    row_keep = keep[np.repeat(np.arange(T), np.diff(np.asarray(j_base)))]
    assert np.abs(tin.numpy() - np.asarray(j_tin)[:n, 3, :])[row_keep].max() <= 1e-4
    assert float(t_final.min()) < 0.5

    x = t(feats).requires_grad_(True)
    rgb2, t2 = tbwd.march_stream_diff(tmarch.train_features(x), t(starts), t(dirs_t), t(eye),
                                      cfg, C, use_kernels=False, quad=True, **text)
    (torch.sum(rgb2 * t(d_rgb)) + torch.sum(t2 * t(d_tfinal))).backward()
    got = x.grad.numpy()
    assert np.isfinite(got).all()
    for c in sorted(tmarch.diff_columns(0)):
        bar = 2e-3 if c in range(3, 12) else 1e-3  # the M columns cancel in float32
        assert np.abs(got[:, c] - j_dfeats[:, c]).max() <= bar * np.abs(j_dfeats[:, c]).max(), c


def test_trainer_fits_on_1024_ray_tiles():
    """Trainer(method="plain").fit on 32x32 tiles in window order, which
    raised before the port trained tiles of more than 256 rays: two finite
    steps, the second with the lower loss."""
    cfg = RenderConfig(**KW, order="window", tile_w=32, tile_h=32, march_chunk=32)
    cam = Camera.create(width=SIZE, height=SIZE, **EYE)
    tr = ttrainer.Trainer(GaussianModel.from_scene(random_scene(300, seed=3)), cfg, lr=1e-2,
                          method="plain")
    losses = tr.fit([(cam, torch.full((SIZE, SIZE, 3), 0.3))], steps=2)
    assert len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0]
