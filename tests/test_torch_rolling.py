"""Rolling shutter on the port (models/rolling.py) against the JAX
package's render_rolling_pallas in interpret mode, and against the port's
own global-shutter render when the camera does not move.

The march runs K1's per-ray-origin scalar mode, here its plain version;
bar >= 60 dB, the bar of the port's whole-slice renders."""

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import CameraModel as JModel
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.rolling import render_rolling_pallas
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig
from gaussian_ray_tracing_tpu_torch.models.renderer import render
from gaussian_ray_tracing_tpu_torch.models.rolling import render_rolling
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
FIELDS = ("means", "scales", "quats", "opacities", "sh")
POSE0 = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=48)
POSE1 = dict(POSE0, eye=(0.05, 0.3, 2.8))  # the eye moves 0.05 in x during readout


@pytest.mark.parametrize("model,order,chunk,sh", [("pinhole", "window", 32, 3),
                                                  ("fisheye", "key", 128, 0)])
def test_rolling_matches_jax_render_rolling_pallas(model, order, chunk, sh):
    js = j_random_scene(800, seed=2)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                  js.num_active)
    cfg = dict(hit_multiplicity=1, order=order, march_chunk=chunk, sh_degree=sh)
    ref = render_rolling_pallas(js, JCamera.create(**POSE0), JCamera.create(**POSE1),
                                JConfig(**cfg, camera_model=JModel(model)))
    before = tmarch.march.origin_launches
    out = render_rolling(ts, Camera.create(**POSE0), Camera.create(**POSE1),
                         RenderConfig(**cfg, camera_model=CameraModel(model)),
                         return_aux=True, use_kernels=False)
    assert tmarch.march.origin_launches == before  # the plain version on the CPU
    assert out["aux"]["n_dropped"] == 0 and out["aux"]["n_pairs"] > 0
    assert psnr(out["rgb"].numpy(), np.asarray(ref["rgb"])) >= 60.0
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60.0
    assert float(out["rgb"].max()) > 0.1


@pytest.mark.parametrize("model", ["pinhole", "fisheye"])
def test_static_rolling_shutter_is_the_global_shutter_frame(model):
    """cam0 == cam1: the same pair stream (the union of three equal rects)
    and the same rays, marched with the scalar response from per-ray
    origins instead of the shared-origin quad response: equal up to float
    noise in the gate."""
    scene = random_scene(800, seed=2)
    cam = Camera.create(**POSE0)
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128,
                       camera_model=CameraModel(model), sh_degree=2)
    rolled = render_rolling(scene, cam, cam, cfg, return_aux=True, use_kernels=False)
    fixed = render(scene, cam, cfg, method="plain", return_aux=True)
    assert rolled["aux"]["n_pairs"] == fixed["aux"]["n_pairs"]
    assert psnr(rolled["rgb"].numpy(), fixed["rgb"].numpy()) >= 60.0


def test_rolling_needs_cuda_tensors_for_the_kernels():
    scene = random_scene(300, seed=1)
    cam = Camera.create(**POSE0)
    with pytest.raises(RuntimeError):
        render_rolling(scene, cam, cam, RenderConfig())
    with pytest.raises(RuntimeError):  # merge order needs CUDA tensors for K1 too
        render_rolling(scene, cam, cam, RenderConfig(order="merge"))
    with pytest.raises(RuntimeError):  # oddeven too
        render_rolling(scene, cam, cam, RenderConfig(order="oddeven"))
    # per-ray origins never take the sqrt-free gate, so oddeven (stream
    # order on the exact event gate) is key order's frame bit for bit
    odd = render_rolling(scene, cam, cam, RenderConfig(order="oddeven"), use_kernels=False)
    key = render_rolling(scene, cam, cam, RenderConfig(order="key"), use_kernels=False)
    assert torch.equal(odd["rgb"], key["rgb"])
    merge = render_rolling(scene, cam, cam, RenderConfig(order="merge"), use_kernels=False)
    assert bool(torch.isfinite(merge["rgb"]).all())
