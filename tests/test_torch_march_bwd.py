"""The port's plain backward (the CPU side of kernel K3) against the JAX
package's hand-written backward `pallas_march_bwd`, run in interpret mode,
on identical (starts, eye, rows, dirs, tin, chunk_base) and a seeded
cotangent; plus the autograd Function that pairs K1 with K3.

Bar: on each column JAX writes, max|a - b| / max|b| <= 1e-3 (the JAX
suite's hand-written-vs-autodiff bar); the radius and every quad column
exactly 0. The residual is XLA's FMA contraction on the CPU and the TPU
kernel's bf16-split prefix sums, against the port's per-operation
float32 rounding."""

import jax
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

torch.set_num_threads(1)
KW = dict(hit_multiplicity=1, order="key")
# JAX feature-table columns the backward writes: mean, M, opacity, sh0
WRITTEN = tuple(range(13)) + (14, 15, 16)


@pytest.fixture(scope="module")
def stream_inputs():
    """One JAX pair stream (64x48, 600 gaussians) as numpy arrays."""
    scene = j_random_scene(600, seed=7)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=48)
    cfg = JConfig(hit_multiplicity=1)
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, _, _ = prepare(scene, cam, cfg, 65_536, 256, False)
    _, dirs, _ = generate_rays(cam, cfg)
    dirs_t = np.array(tile_rays(dirs, 16, 16))
    rng = np.random.default_rng(11)
    return dict(
        starts=np.array(stream.starts), eye=np.array(cam.eye),
        pair_feats=np.array(pair_feats), dirs_t=dirs_t,
        d_rgb=rng.normal(size=dirs_t.shape).astype(np.float32),
        d_tfinal=rng.normal(size=dirs_t.shape[:2]).astype(np.float32),
    )


@pytest.mark.parametrize("chunk", [32, 256])
def test_plain_backward_matches_pallas(stream_inputs, chunk):
    inp = stream_inputs
    cfg = JConfig(march_chunk=chunk, **KW)
    T, R = inp["dirs_t"].shape[:2]
    _, _, tin, chunk_base = pallas_march_stream(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], cfg, n_tiles=T,
        rays_per_tile=R, chunk=chunk, interpret=True, save_tin=True, quad=True)
    want = np.asarray(pallas_march_bwd(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], tin, chunk_base,
        inp["d_rgb"], inp["d_tfinal"], cfg, n_tiles=T, rays_per_tile=R, chunk=chunk,
        interpret=True))
    n = int(chunk_base[-1])
    t = lambda x: torch.from_numpy(np.array(x))
    rows = tmarch.train_features(t(inp["pair_feats"]))
    got = tbwd.march_bwd(t(inp["starts"]), rows, t(inp["dirs_t"]), t(inp["eye"]),
                         t(np.asarray(tin)[:n, 3, :]), t(np.asarray(chunk_base)),
                         t(inp["d_rgb"]), t(inp["d_tfinal"]), RenderConfig(march_chunk=chunk,
                                                                           **KW), chunk)
    got = got.numpy()
    assert np.isfinite(got).all()
    for i, c in enumerate(tmarch.TRAIN_COLUMNS):
        if c in WRITTEN:
            b = want[:, c]
            assert np.abs(got[:, i] - b).max() / np.abs(b).max() <= 1e-3, (i, c)
        else:  # the radius, every quad column and the pad: exactly zero
            assert not got[:, i].any(), (i, c)
    assert np.abs(got[:, tmarch.T_MX : tmarch.T_MX + 3]).max() > 0


def test_autograd_function_pairs_k1_and_k3(stream_inputs):
    """MarchStreamDiff: the forward is the save_tin march, the backward is
    march_bwd on the saved carries, with no gradient to starts, dirs or eye
    and no kernel launch for CPU tensors."""
    inp = stream_inputs
    t = lambda x: torch.from_numpy(np.array(x))
    cfg = RenderConfig(march_chunk=64, **KW)
    starts, dirs_t, eye = t(inp["starts"]), t(inp["dirs_t"]), t(inp["eye"])
    rows = tmarch.train_features(t(inp["pair_feats"])).requires_grad_(True)
    before = (tmarch.march.launches, tbwd.march_bwd.launches)
    rgb, t_final = tbwd.march_stream_diff(rows, starts, dirs_t, eye, cfg, 64)
    (torch.sum(rgb * t(inp["d_rgb"])) + torch.sum(t_final * t(inp["d_tfinal"]))).backward()
    assert (tmarch.march.launches, tbwd.march_bwd.launches) == before
    ref_rgb, ref_t, tin, base = tmarch.march(starts, rows.detach(), dirs_t, cfg, 64,
                                             save_tin=True)
    assert torch.equal(rgb, ref_rgb) and torch.equal(t_final, ref_t)
    ref = tbwd.march_bwd_plain(starts, rows.detach(), dirs_t, eye, tin, base,
                               t(inp["d_rgb"]), t(inp["d_tfinal"]), cfg, 64)
    assert torch.equal(rows.grad, ref)
    with pytest.raises(NotImplementedError):  # merge trains as key upstream, never here
        tbwd.march_bwd(starts, rows.detach(), dirs_t, eye, tin, base, t(inp["d_rgb"]),
                       t(inp["d_tfinal"]), RenderConfig(march_chunk=64, order="merge"), 64)
