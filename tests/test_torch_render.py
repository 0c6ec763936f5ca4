"""The whole ported slice: render(method="plain") against the JAX package's
render_pallas (interpret mode) and against the exact-oracle 256^2 goldens,
for pinhole, fisheye and OpenCV cameras and SH degrees 0 and 3, plus
supersampling, the package's entry points and its independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import CameraModel as JModel
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import render_pallas
from gaussian_ray_tracing_tpu.models.renderer import render as j_render
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig
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


def test_key_order_slice_matches_jax_render_pallas():
    """The key-order forward render (the training forward without saved
    carries): 96x64, 800 gaussians, the JAX suite's quad-path bar."""
    js = j_random_scene(800, seed=5)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                  js.num_active)
    kw = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    key = dict(hit_multiplicity=1, order="key", march_chunk=256)
    ref = render_pallas(js, JCamera.create(**kw), JConfig(**key), pair_capacity=65_536,
                        interpret=True)
    out = render(ts, Camera.create(**kw), RenderConfig(**key), method="plain",
                 pair_capacity=65_536)
    a, b = out["rgb"].numpy(), np.asarray(ref["rgb"])
    assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 70.0


@pytest.mark.parametrize("model,dist,sh", [("fisheye", (), 0), ("fisheye", (), 3),
                                          ("opencv", (-0.25, 0.05, 0.0, 0.0), 0),
                                          ("opencv", (-0.25, 0.05, 0.0, 0.0), 3)])
def test_camera_slice_matches_jax_render_pallas(model, dist, sh):
    """Fisheye and OpenCV frames at SH 0 and 3, 96x64, 800 gaussians, bench
    config, against render_pallas: >= 60 dB and an equal pair count, the
    bar of test_slice_matches_jax_render_pallas."""
    js = j_random_scene(800, seed=5)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                  js.num_active)
    kw = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    cfg = dict(BENCH, sh_degree=sh, distortion=dist)
    ref = render_pallas(js, JCamera.create(**kw), JConfig(**cfg, camera_model=JModel(model)),
                        pair_capacity=65_536, interpret=True, return_aux=True)
    out = render(ts, Camera.create(**kw), RenderConfig(**cfg, camera_model=CameraModel(model)),
                 method="plain", pair_capacity=65_536, return_aux=True)
    assert out["aux"]["n_pairs"] == int(ref["aux"]["n_pairs"])
    assert out["aux"]["n_dropped"] == int(ref["aux"]["n_dropped"]) == 0
    assert psnr(out["rgb"].numpy(), np.asarray(ref["rgb"])) >= 60.0
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60.0
    if model == "fisheye":  # the r > 1 ring is blanked
        assert not out["rgb"][0, 0].any() and float(out["rgb"][32, 48].max()) > 0.0


def test_supersample_matches_jax():
    """supersample=2 (a 64x48 frame box-filtered to 32x24) against the JAX
    package's render(..., supersample=2, method="pallas") (key order)."""
    js = j_random_scene(800, seed=5)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                  js.num_active)
    kw = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=32, height=24)
    key = dict(hit_multiplicity=1, order="key", march_chunk=128)
    ref = j_render(js, JCamera.create(**kw), JConfig(**key), method="pallas", supersample=2)
    out = render(ts, Camera.create(**kw), RenderConfig(**key), method="plain", supersample=2)
    assert out["rgb"].shape == (24, 32, 3) and out["alpha"].shape == (24, 32)
    assert psnr(out["rgb"].numpy(), np.asarray(ref["rgb"])) >= 60.0
    assert psnr(out["alpha"].numpy(), np.asarray(ref["alpha"])) >= 60.0


@pytest.mark.parametrize("name", ["small_pinhole_256", "small_hm2_256", "small_fisheye_256"])
def test_golden_256(name):
    """>= 40 dB against the exact per-ray-ordered oracle goldens, the bar
    of tests/test_golden_small.py, through the port's plain path."""
    z = np.load(os.path.join(ROOT, "data", "golden", f"{name}.npz"))
    n, seed, width, height, hm, fisheye = (int(v) for v in z["meta"])
    scene = random_scene(n, seed=seed)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0),
                        width=width, height=height)
    cfg = RenderConfig(hit_multiplicity=hm, order="window", march_chunk=128,
                       max_per_tile=4096,
                       camera_model=CameraModel.FISHEYE if fisheye else CameraModel.PINHOLE)
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
    with pytest.raises(RuntimeError):  # merge order needs the card for its kernel too
        render(scene, cam, RenderConfig(order="merge"), method="gpu")
    with pytest.raises(RuntimeError):  # oddeven runs K1 on the card too
        render(scene, cam, RenderConfig(order="oddeven"), method="gpu")
    odd = render(scene, cam, RenderConfig(order="oddeven"), method="plain")["rgb"]
    assert odd.shape == (32, 32, 3) and bool(torch.isfinite(odd).all())
    merge = render(scene, cam, RenderConfig(order="merge"), method="plain")["rgb"]
    assert merge.shape == (32, 32, 3) and bool(torch.isfinite(merge).all())


def test_tracer_loads_ply_on_cuda_unless_told_otherwise():
    """GaussianRayTracer(ply_path=...) puts the scene on CUDA by default, so
    without a card it raises; device="cpu" is the explicit way to the CPU."""
    ply = os.path.join(ROOT, "data", "fitted_20k.ply")
    if torch.cuda.is_available():
        assert GaussianRayTracer(ply_path=ply).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            GaussianRayTracer(ply_path=ply)
    tracer = GaussianRayTracer(ply_path=ply, device="cpu")
    assert tracer.device.type == "cpu" and tracer.scene.num_active == 20_000
    tracer.set_size(32, 32)
    tracer.set_camera_model("fisheye")
    assert tracer.config.camera_model == CameraModel.FISHEYE
    frame = tracer.render_rgb8()
    assert frame.shape == (32, 32, 3) and not frame[0, 0].any() and frame.max() > 0
    assert tracer.render_rgb8(supersample=2).shape == (32, 32, 3)


def test_training_and_mesh_take_fisheye_and_sh():
    """Fisheye, OpenCV and SH > 0 train (the differentiable render returns
    the forward render's frame, here at 32x32 to 1e-5, the fisheye corner
    blank) and trace mesh bounces: the frame is finite, differs from the
    mesh-less frame, and keeps the fisheye corner blank."""
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.renderer import render_diff
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_plane

    scene = random_scene(300, seed=1)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=32, height=32)
    plane = make_plane((0.0, 0.0, 0.5))
    for change in (dict(camera_model=CameraModel.FISHEYE), dict(sh_degree=1),
                   dict(camera_model=CameraModel.OPENCV, distortion=(-0.2, 0.0, 0.0, 0.0))):
        cfg = RenderConfig(order="key", chunk_skip_transmittance=1e-3, **change)
        model = GaussianModel.from_scene(scene).requires_grad_(True)
        out = render_diff(model.activate(), cam, cfg)
        with torch.no_grad():
            ref = render(model.activate(), cam, cfg)["rgb"]
        assert float((out["rgb"] - ref).abs().max()) <= 1e-5
        out["rgb"].sum().backward()
        assert bool(torch.isfinite(model.means.grad).all()) and model.means.grad.any()
        if "sh_degree" in change:
            assert model.sh.grad[:, 1:4].any() and not model.sh.grad[:, 4:].any()
        if change.get("camera_model") == CameraModel.FISHEYE:
            assert not out["rgb"][0, 0].any()
        mesh_cfg = RenderConfig(mesh_type=MeshType.NORMAL, **change)
        framed = render(scene, cam, mesh_cfg, mesh=plane)["rgb"]
        assert bool(torch.isfinite(framed).all())
        assert not torch.equal(framed, render(scene, cam, mesh_cfg)["rgb"])
        if change.get("camera_model") == CameraModel.FISHEYE:
            assert not framed[0, 0].any()


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
    # with a primitive the frame goes through the mesh tracer; removing it
    # brings the plain frame back
    assert tracer.create_plane(mesh_type="normal") == 0
    assert not np.array_equal(tracer.render_rgb8(), frame)
    tracer.remove_primitive(0)
    assert np.array_equal(tracer.render_rgb8(), frame)


@pytest.mark.parametrize("flags", [[], ["--fisheye"], ["--distortion", "-0.25", "0.05", "0", "0"],
                                   ["--sh-degree", "3", "--order", "key"], ["--supersample", "2"]])
def test_cli_render_writes_png(tmp_path, flags):
    from gaussian_ray_tracing_tpu_torch import cli

    out = tmp_path / "frame.png"
    cli.main(["render", "--synthetic", "1500", "--width", "40", "--height", "24",
              "--device", "cpu", "-o", str(out), *flags])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_needs_cuda_unless_told_cpu(tmp_path):
    """--device defaults to cuda: without a card the CLI raises rather than
    falling back to the CPU."""
    from gaussian_ray_tracing_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cmd in ("render", "fit"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main([cmd, "--synthetic", "300", "--width", "16", "--height", "16",
                      "-o", str(tmp_path / "x")])


def test_package_imports_without_jax():
    """With jax made unimportable, the port imports and renders a frame."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gaussian_ray_tracing_tpu_torch.cameras import Camera\n"
        "from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig\n"
        "from gaussian_ray_tracing_tpu_torch.models.renderer import render\n"
        "from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene\n"
        "from gaussian_ray_tracing_tpu_torch import cli\n"
        "from gaussian_ray_tracing_tpu_torch.train import losses, trainer\n"
        "from gaussian_ray_tracing_tpu_torch.ops import march_bwd\n"
        "cam = Camera.create(eye=(0, 0.3, 2.8), lookat=(0, 0, 0), width=32, height=32)\n"
        "out = render(random_scene(500, seed=0), cam, RenderConfig())\n"
        "assert out['rgb'].shape == (32, 32, 3) and float(out['rgb'].max()) > 0\n"
        "from gaussian_ray_tracing_tpu_torch.config import CameraModel\n"
        "from gaussian_ray_tracing_tpu_torch.models.rolling import render_rolling\n"
        "fish = RenderConfig(camera_model=CameraModel.FISHEYE, sh_degree=3)\n"
        "out = render(random_scene(500, seed=0), cam, fish)\n"
        "assert float(out['rgb'].max()) > 0 and not out['rgb'][0, 0].any()\n"
        "cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0, 0, 0), width=32, height=32)\n"
        "out = render_rolling(random_scene(500, seed=0), cam, cam1, RenderConfig(),\n"
        "                     use_kernels=False)\n"
        "assert float(out['rgb'].max()) > 0\n"
        "assert not any(m == 'gaussian_ray_tracing_tpu' or m.startswith(\n"
        "    'gaussian_ray_tracing_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
