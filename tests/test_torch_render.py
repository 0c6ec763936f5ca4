"""The whole ported slice: render(method="plain") against the JAX package's
render_pallas (interpret mode) and against the exact-oracle 256^2 goldens,
plus the package's entry points and its independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import render_pallas
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("means", "scales", "quats", "opacities", "sh")
BENCH = dict(hit_multiplicity=1, order="window", march_chunk=128)


def test_slice_matches_jax_render_pallas():
    """96x64, 800 gaussians, bench config: >= 60 dB and equal pair count
    (the port computes its own footprints, so float noise may move a
    pair between chunks; the bar allows for it)."""
    js = j_random_scene(800, seed=5)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                  js.num_active)
    kw = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    ref = render_pallas(js, JCamera.create(**kw), JConfig(**BENCH),
                        pair_capacity=65_536, interpret=True, return_aux=True)
    out = render(ts, Camera.create(**kw), RenderConfig(**BENCH), method="plain",
                 pair_capacity=65_536, return_aux=True)
    assert out["aux"]["n_pairs"] == int(ref["aux"]["n_pairs"])
    assert out["aux"]["n_dropped"] == int(ref["aux"]["n_dropped"]) == 0
    assert psnr(out["rgb"].numpy(), np.asarray(ref["rgb"])) >= 60.0
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60.0


@pytest.mark.parametrize("name", ["small_pinhole_256", "small_hm2_256"])
def test_golden_256(name):
    """>= 40 dB against the exact per-ray-ordered oracle goldens, the bar
    of tests/test_golden_small.py, through the port's plain path."""
    z = np.load(os.path.join(ROOT, "data", "golden", f"{name}.npz"))
    n, seed, width, height, hm, fisheye = (int(v) for v in z["meta"])
    assert not fisheye
    scene = random_scene(n, seed=seed)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0),
                        width=width, height=height)
    cfg = RenderConfig(hit_multiplicity=hm, order="window", march_chunk=128,
                       max_per_tile=4096)
    out = render(scene, cam, cfg, method="plain", return_aux=True)
    assert out["aux"]["n_dropped"] == 0
    assert psnr(out["rgb"].numpy(), z["rgb"].astype(np.float32)) >= 40.0


def test_gpu_method_never_falls_back_to_cpu():
    scene = random_scene(300, seed=1)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=32, height=32)
    with pytest.raises(RuntimeError):
        render(scene, cam, RenderConfig(), method="gpu")
    with pytest.raises(ValueError):
        render(scene, cam, RenderConfig(), method="pallas")
    with pytest.raises(NotImplementedError):
        render(scene, cam, RenderConfig(order="key"), method="plain")


def test_tracer_render_and_capacity_bucket():
    tracer = GaussianRayTracer(scene=random_scene(1000, seed=2),
                               config=RenderConfig(**BENCH))
    tracer.set_size(48, 32)
    assert tracer.camera.width == 48 and tracer.camera.height == 32
    tracer.update_camera(Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0),
                                       width=48, height=32))
    frame = tracer.render_rgb8()
    assert frame.shape == (32, 48, 3) and frame.dtype == np.uint8 and frame.max() > 0
    assert tracer._pair_capacity >= 1 << 16
    tracer._pair_capacity = 1  # a too-small bucket is outgrown, never dropped
    again = tracer.render_rgb8(method="plain")
    assert np.array_equal(frame, again)
    with pytest.raises(NotImplementedError):
        tracer.create_plane()


def test_cli_render_writes_png(tmp_path):
    from gaussian_ray_tracing_tpu_torch import cli

    out = tmp_path / "frame.png"
    cli.main(["render", "--synthetic", "1500", "--width", "40", "--height", "24",
              "--device", "cpu", "-o", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_package_imports_without_jax():
    """With jax made unimportable, the port imports and renders a frame."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gaussian_ray_tracing_tpu_torch.cameras import Camera\n"
        "from gaussian_ray_tracing_tpu_torch.config import RenderConfig\n"
        "from gaussian_ray_tracing_tpu_torch.models.renderer import render\n"
        "from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene\n"
        "from gaussian_ray_tracing_tpu_torch import cli\n"
        "cam = Camera.create(eye=(0, 0.3, 2.8), lookat=(0, 0, 0), width=32, height=32)\n"
        "out = render(random_scene(500, seed=0), cam, RenderConfig())\n"
        "assert out['rgb'].shape == (32, 32, 3) and float(out['rgb'].max()) > 0\n"
        "assert not any(m == 'gaussian_ray_tracing_tpu' or m.startswith(\n"
        "    'gaussian_ray_tracing_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
