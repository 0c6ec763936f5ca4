"""The training modes of the port's plain K1 and K3 against the JAX
package on the CPU: window order with saved carries (the scalar response
from the eye and the training sort key) and SH 1 and 3 in both orders,
against `pallas_march_stream(save_tin=True)` and `pallas_march_bwd` in
interpret mode on one JAX pair stream (64x48, 600 gaussians, all 16 SH
coefficients); and the window backward against jax.grad of
scripts/window_bwd_replica.replica_march, the JAX suite's ground truth for
the routing of gradients through the per-ray sort
(tests/test_pallas.py:271-328).

Bars: rgb and T PSNR >= 70 dB and max abs <= 1e-2 (the quad-path bar;
in window order at SH > 0 JAX's forward evaluates the colour through its
bf16 hi/lo MXU split, ~4e-6 relative, which can move a 10-bit colour pack
by one step), the saved carries max abs <= 1e-4; per written column of
d(rows) max|a - b| / max|b| <= 1e-3 (the JAX suite's hand-written-backward
bar), every other column exactly 0; against the replica, the loss at rtol
1e-4 and the gradient at 1e-3 of its largest entry, as the JAX suite holds
its own kernel."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_bwd, pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (order, SH degree, chunk)
CASES = [("window", 0, 32), ("window", 1, 32), ("window", 3, 32), ("key", 1, 32),
         ("key", 3, 32)]


@functools.lru_cache(maxsize=None)
def _stream():
    """One JAX pair stream with the SH 3 feature table, and a cotangent."""
    scene = j_random_scene(600, seed=7)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=48)
    cfg = JConfig(hit_multiplicity=1, sh_degree=3)
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, _, _ = prepare(scene, cam, cfg, 65_536, 32, False)
    _, dirs, _ = generate_rays(cam, cfg)
    dirs_t = np.array(tile_rays(dirs, 16, 16))
    rng = np.random.default_rng(11)
    return dict(starts=np.array(stream.starts), eye=np.array(cam.eye),
                pair_feats=np.array(pair_feats), dirs_t=dirs_t,
                d_rgb=rng.normal(size=dirs_t.shape).astype(np.float32),
                d_tfinal=rng.normal(size=dirs_t.shape[:2]).astype(np.float32))


def _feats(degree: int) -> np.ndarray:
    """The JAX feature layout at SH `degree` from the SH 3 stream's rows."""
    pf = _stream()["pair_feats"]
    K = (degree + 1) ** 2
    head = np.concatenate([pf[:, :14], *(pf[:, 14 + 16 * ch : 14 + 16 * ch + K]
                                         for ch in range(3))], axis=1)
    pad = np.zeros((pf.shape[0], 64 - head.shape[1]), np.float32)
    return np.concatenate([head, pad, pf[:, 64:]], axis=1)


@functools.lru_cache(maxsize=None)
def _jax(order: str, degree: int, chunk: int):
    """The TPU kernels in interpret mode: forward with saved carries (key:
    the quad response, window: the scalar one, as render_pallas_diff runs
    them), then the backward on the seeded cotangent."""
    inp, feats = _stream(), _feats(degree)
    cfg = JConfig(hit_multiplicity=1, order=order, march_chunk=chunk, sh_degree=degree)
    T, R = inp["dirs_t"].shape[:2]
    rgb, t_final, tin, base = pallas_march_stream(
        inp["starts"], inp["eye"], feats, inp["dirs_t"], cfg, n_tiles=T, rays_per_tile=R,
        chunk=chunk, interpret=True, save_tin=True, quad=order == "key")
    d_feats = pallas_march_bwd(inp["starts"], inp["eye"], feats, inp["dirs_t"], tin, base,
                               inp["d_rgb"], inp["d_tfinal"], cfg, n_tiles=T, rays_per_tile=R,
                               chunk=chunk, interpret=True)
    n = int(np.asarray(base)[-1])
    return (np.asarray(rgb), np.asarray(t_final), np.asarray(tin)[:n, 3, :], np.asarray(base),
            np.asarray(d_feats))


def _port(order: str, degree: int, chunk: int):
    inp = _stream()
    t = lambda x: torch.from_numpy(np.array(x))
    rows = tmarch.train_features(t(_feats(degree)), degree)
    cfg = RenderConfig(hit_multiplicity=1, order=order, march_chunk=chunk, sh_degree=degree)
    dirs_t = t(inp["dirs_t"])
    # window order: the scalar response from per-ray origins, each the eye
    origins_t = t(inp["eye"]).expand(dirs_t.shape).contiguous() if order == "window" else None
    fwd = tmarch.march(t(inp["starts"]), rows, dirs_t, cfg, chunk, save_tin=True,
                       origins_t=origins_t)
    return cfg, rows, fwd


@pytest.mark.parametrize("order,degree,chunk", CASES)
def test_plain_training_march_matches_pallas(order, degree, chunk):
    j_rgb, j_t, j_tin, j_base, _ = _jax(order, degree, chunk)
    _, rows, (rgb, t_final, tin, base) = _port(order, degree, chunk)
    assert rows.shape[1] == tmarch.train_row(degree)
    for a, b in ((rgb.numpy(), j_rgb), (t_final.numpy(), j_t)):
        assert a.shape == b.shape
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    assert np.array_equal(base.numpy(), j_base)
    assert float(np.abs(tin.numpy() - j_tin).max()) <= 1e-4
    assert float(t_final.min()) < 0.5  # the stream really composites


@pytest.mark.parametrize("order,degree,chunk", CASES)
def test_plain_training_backward_matches_pallas(order, degree, chunk):
    want = _jax(order, degree, chunk)[4]
    cfg, rows, (_, _, tin, base) = _port(order, degree, chunk)
    inp = _stream()
    t = lambda x: torch.from_numpy(np.array(x))
    got = tbwd.march_bwd(t(inp["starts"]), rows, t(inp["dirs_t"]), t(inp["eye"]), tin, base,
                         t(inp["d_rgb"]), t(inp["d_tfinal"]), cfg, chunk).numpy()
    assert np.isfinite(got).all()
    diff = tmarch.diff_columns(degree)
    for i, c in enumerate(tmarch.train_columns(degree)):
        if c in diff:
            b = want[:, c]
            assert np.abs(got[:, i] - b).max() / np.abs(b).max() <= 1e-3, (i, c)
        else:  # the radius, every quad column and the pad: exactly zero
            assert not got[:, i].any(), (i, c)
    if degree:  # the higher bands really get a gradient
        assert np.abs(got[:, tmarch.T_SH0 + 1 : tmarch.T_SH0 + (degree + 1) ** 2]).max() > 0


def test_window_backward_matches_jax_grad_of_the_replica():
    """tests/test_pallas.py:271-328's setup (32x16, 300 gaussians, c=32,
    min_transmittance 1e-8): the port's plain window training march and its
    backward (MarchStreamDiff) against jax.grad of the pure-jnp replica."""
    sys.path.insert(0, ROOT)
    from scripts.window_bwd_replica import replica_march

    from gaussian_ray_tracing_tpu.ops.tiles import num_tiles

    c = 32
    cfg = JConfig(hit_multiplicity=1, order="window", march_chunk=c, max_per_tile=4096,
                  min_transmittance=1e-8)
    scene = j_random_scene(300, seed=6)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=32, height=16)
    stream, pair_feats, _, _ = prepare_pair_stream(scene, cam, cfg, 50_000, c)
    _, dirs, _ = generate_rays(cam, cfg)
    dirs_t = tile_rays(dirs, cfg.tile_w, cfg.tile_h)
    tx, ty = num_tiles(cam, cfg)
    T, R = tx * ty, cfg.rays_per_tile
    eye = cam.eye.astype(jnp.float32)
    W = jax.random.normal(jax.random.PRNGKey(0), (T, R, 3))

    def loss_replica(feats):
        rgb, _ = replica_march(stream.starts, eye, feats, dirs_t, cfg, T, R, c)
        return jnp.sum(rgb * W)

    lr, gr = jax.value_and_grad(loss_replica)(pair_feats)
    gr = np.asarray(gr)[:, :17]  # the columns the kernel writes at SH 0

    t = lambda x: torch.from_numpy(np.array(x))
    feats = t(pair_feats).requires_grad_(True)
    rows = tmarch.train_features(feats)
    tcfg = RenderConfig(hit_multiplicity=1, order="window", march_chunk=c,
                        min_transmittance=1e-8)
    rgb, _ = tbwd.march_stream_diff(rows, t(stream.starts), t(dirs_t), t(eye), tcfg, c,
                                    use_kernels=False)
    loss = torch.sum(rgb * t(W))
    loss.backward()
    assert abs(float(loss.detach()) - float(lr)) <= 1e-4 * abs(float(lr))
    gk = feats.grad.numpy()[:, :17]
    assert np.isfinite(gk).all()
    assert np.abs(gk - gr).max() / np.abs(gr).max() <= 1e-3
