"""The port's CUDA kernels against their plain torch versions on the card.

Marked `gpu`: they need CUDA and nvcc and skip elsewhere. This file
imports no jax, so on a machine without jax run it without the suite's
conftest (which configures jax):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import os

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu_torch.models.renderer import render
from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import scan as tscan
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

pytestmark = pytest.mark.gpu
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _needs_cuda():
    # decided per test, not at import, so every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def test_scan_kernel_is_exact():
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((2, 1_500_000), (16, 70_001), (3, 1000), (1, 1)):
        x = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device="cuda",
                          generator=g)
        before = tscan.multi_cumsum_i32.launches
        got = tscan.multi_cumsum_i32(x)
        assert tscan.multi_cumsum_i32.launches == before + 1
        assert torch.equal(got, tscan.multi_cumsum_i32_plain(x)), shape


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
@pytest.mark.parametrize("hm,skip", [(1, 0.02), (2, 1e-3)])
def test_march_kernel_matches_plain(chunk, hm, skip):
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256,
                        height=256, device="cuda")
    cfg = RenderConfig(hit_multiplicity=hm, march_chunk=chunk,
                       chunk_skip_transmittance=skip)
    stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 18)
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], 16, 16)
    before = tmarch.march.launches
    rgb, t_final = tmarch.march(stream.starts, feats, dirs_t, cfg, chunk)
    torch.cuda.synchronize()
    assert tmarch.march.launches == before + 1
    rgb_p, t_p = tmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk)
    for a, b in ((rgb, rgb_p), (t_final, t_p)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


@pytest.mark.parametrize("name", ["small_pinhole_256", "small_hm2_256"])
def test_gpu_render_matches_golden_and_plain(name):
    z = np.load(os.path.join(ROOT, "data", "golden", f"{name}.npz"))
    n, seed, width, height, hm, _ = (int(v) for v in z["meta"])
    scene = random_scene(n, seed=seed, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=width,
                        height=height, device="cuda")
    cfg = RenderConfig(hit_multiplicity=hm, march_chunk=128)
    gpu = render(scene, cam, cfg, method="gpu")["rgb"].cpu().numpy()
    plain = render(scene, cam, cfg, method="plain")["rgb"].cpu().numpy()
    assert psnr(gpu, z["rgb"].astype(np.float32)) >= 40.0
    assert psnr(gpu, plain) >= 70.0
