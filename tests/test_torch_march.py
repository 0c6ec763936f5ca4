"""The port's plain march (the CPU side of kernel K1) against the JAX
Pallas march, run as the JAX suite runs it on the CPU (interpret mode),
on the identical (starts, pair_feats, dirs_t) of one JAX pair stream.

Bars are the JAX suite's own for the quad path (tests/test_pallas.py):
PSNR >= 70 dB and max abs <= 1e-2 on rgb and final transmittance. The
residual comes from the TPU kernel's bf16 hi/lo prefix sums (~2^-16
relative), exp/log ulps, and exact key ties in fired chunks, where the
TPU's bitonic network may duplicate one colour pack."""

import jax
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
SWEEP = [(c, hm, skip) for c in (64, 128) for hm in (1, 2) for skip in (1e-3, 0.02)]


@pytest.fixture(scope="module")
def stream_inputs():
    """One JAX pair stream (96x64, 800 gaussians) as numpy arrays."""
    scene = j_random_scene(800, seed=5)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    cfg = JConfig(hit_multiplicity=1)
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, _, _ = prepare(scene, cam, cfg, 65_536, 128, False)
    _, dirs, _ = generate_rays(cam, cfg)
    return dict(
        starts=np.array(stream.starts), eye=np.array(cam.eye),
        pair_feats=np.array(pair_feats), dirs_t=np.array(tile_rays(dirs, 16, 16)),
    )


def _torch_args(inp):
    return (torch.from_numpy(inp["starts"]), torch.from_numpy(inp["pair_feats"]),
            torch.from_numpy(inp["dirs_t"]))


@pytest.mark.parametrize("chunk,hm,skip", SWEEP)
def test_plain_march_matches_pallas(stream_inputs, chunk, hm, skip):
    inp = stream_inputs
    kw = dict(hit_multiplicity=hm, march_chunk=chunk, chunk_skip_transmittance=skip)
    T, R = inp["dirs_t"].shape[:2]
    j_rgb, j_t = pallas_march_stream(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], JConfig(**kw),
        n_tiles=T, rays_per_tile=R, chunk=chunk, interpret=True, quad=True,
        packed16=False,
    )
    j_rgb, j_t = np.asarray(j_rgb), np.asarray(j_t)
    rgb, t_final = tmarch.march_stream(*_torch_args(inp), RenderConfig(**kw), chunk)
    assert rgb.shape == j_rgb.shape and t_final.shape == j_t.shape
    for a, b in ((rgb.numpy(), j_rgb), (t_final.numpy(), j_t)):
        assert psnr(a, b) >= 70.0
        assert np.abs(a - b).max() <= 1e-2
    assert float(t_final.min()) < 0.5  # the stream really composites


def test_wrapper_uses_plain_version_on_cpu(stream_inputs):
    starts, feats, dirs_t = _torch_args(stream_inputs)
    compact = tmarch.compact_features(feats)
    assert compact.shape == (feats.shape[0], tmarch.ROW)
    assert torch.equal(compact[:, 0], feats[:, 12])
    assert torch.equal(compact[:, 12:15], feats[:, 77:80])
    before = tmarch.march.launches
    a = tmarch.march(starts, compact, dirs_t, RenderConfig(), 128)
    b = tmarch.march_plain(starts, compact, dirs_t, RenderConfig(), 128)
    assert tmarch.march.launches == before  # no kernel launch on the CPU
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_march_rejects_unsupported_arguments(stream_inputs):
    starts, feats, dirs_t = _torch_args(stream_inputs)
    compact = tmarch.compact_features(feats)
    with pytest.raises(NotImplementedError):
        tmarch.march(starts, compact, dirs_t, RenderConfig(), 96)
    with pytest.raises(ValueError):
        tmarch.march(starts, feats, dirs_t, RenderConfig(), 128)  # not compact rows
    with pytest.raises(ValueError):
        tmarch.march(starts[:-1], compact, dirs_t, RenderConfig(), 128)
