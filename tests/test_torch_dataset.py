"""NeRF-synthetic datasets, PNG reading and Lanczos downscaling against the
JAX package and PIL, and `cli fit --dataset / --densify / --checkpoint-dir`
with `cli eval`, on the CPU.

Bars: read_png equals PIL's decoding exactly (gray, RGB, RGBA; PIL writes
with adaptive filters, so all five filter types occur); resize_lanczos
within 1/255 of PIL's Image.LANCZOS (it reproduces PIL's fixed-point
arithmetic and, for RGBA, its premultiplied resampling, and is in fact
exact on these images); load_nerf_synthetic's cameras equal JAX's field by
field and its images within 1/255 of JAX's (exact at downscale 1)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_ray_tracing_tpu.scene.dataset import load_nerf_synthetic as j_load
from gaussian_ray_tracing_tpu_torch import cli
from gaussian_ray_tracing_tpu_torch.scene.dataset import load_nerf_synthetic
from gaussian_ray_tracing_tpu_torch.train.trainer import checkpoint_steps
from gaussian_ray_tracing_tpu_torch.utils.image import read_png, resize_lanczos, write_png

torch.set_num_threads(1)


def _image(rng, h: int, w: int, channels: int) -> np.ndarray:
    """A smooth ramp with noise and hard edges; RGBA gets a soft alpha with
    fully transparent and fully opaque regions."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 80 * np.sin(x / 5.0)[..., None] * np.cos(y / 7.0)[..., None]
    img = base + rng.normal(0, 25, size=(h, w, channels))
    img[h // 3 : h // 2, :, :] = 250.0
    img = np.clip(img, 0, 255).astype(np.uint8)
    if channels == 4:
        a = np.clip(255 * (x / w) * 1.6 - 40, 0, 255).astype(np.uint8)
        a[:, : w // 5] = 0
        a[: h // 4] = 255
        img[..., 3] = a
    return img[..., 0] if channels == 1 else img


def _rgba_dataset(root, splits=(("train", 3), ("test", 2)), w=24, h=16):
    """A NeRF-synthetic layout of RGBA frames written by PIL, cameras on a
    ring at radius 2.8 looking at the origin."""
    rng = np.random.default_rng(0)
    for split, n in splits:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            a = 2.0 * np.pi * (i + 0.25) / n
            eye = np.array([2.8 * np.sin(a), 0.4, 2.8 * np.cos(a)])
            z = eye / np.linalg.norm(eye)  # the camera looks down -z
            x = np.cross([0.0, 1.0, 0.0], z)
            x /= np.linalg.norm(x)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
            Image.fromarray(_image(rng, h, w, 4), "RGBA").save(
                os.path.join(root, split, f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.7854, "frames": frames}, f)
    return str(root)


@pytest.fixture(scope="module")
def rgba_root(tmp_path_factory):
    return _rgba_dataset(tmp_path_factory.mktemp("nerf"))


@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("RGBA", 4)])
def test_read_png_matches_pil(tmp_path, mode, channels):
    img = _image(np.random.default_rng(channels), 37, 53, channels)
    path = str(tmp_path / "x.png")
    Image.fromarray(img, mode).save(path)  # PIL's adaptive filters: types 0-4
    got = read_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(Image.open(path)))
    if channels == 3:  # and the port's own writer (filter 0)
        write_png(path, img)
        assert np.array_equal(read_png(path), img)


@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("RGBA", 4)])
@pytest.mark.parametrize("size", [(26, 18), (13, 9), (53, 12), (17, 37)])
def test_lanczos_downscale_matches_pil(mode, channels, size):
    img = _image(np.random.default_rng(7 + channels), 37, 53, channels)
    want = np.asarray(Image.fromarray(img, mode).resize(size, Image.LANCZOS))
    got = resize_lanczos(img, *size)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("white", [True, False])
def test_dataset_matches_jax(rgba_root, downscale, white):
    jviews, jmeta = j_load(rgba_root, downscale=downscale, white_background=white)
    views, meta = load_nerf_synthetic(rgba_root, downscale=downscale, white_background=white,
                                      device="cpu")
    assert len(views) == len(jviews) == 3
    for (cam, img), (jcam, jimg) in zip(views, jviews):
        for k in ("eye", "lookat", "up"):
            assert np.array_equal(getattr(cam, k).numpy(), np.asarray(getattr(jcam, k))), k
        assert (cam.fov_y_deg, cam.width, cam.height) == (jcam.fov_y_deg, jcam.width,
                                                          jcam.height)
        assert img.dtype == torch.float32 and img.shape == jimg.shape
        assert float(np.abs(img.numpy() - jimg).max()) <= (0.0 if downscale == 1 else 1 / 255)
    np.testing.assert_array_equal(meta["center"], jmeta["center"])
    assert meta["extent"] == jmeta["extent"]
    assert len(load_nerf_synthetic(rgba_root, max_views=2, device="cpu")[0]) == 2
    assert len(load_nerf_synthetic(rgba_root, split="test", device="cpu")[0]) == 2


def test_dataset_needs_cuda_unless_told_cpu(rgba_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_nerf_synthetic(rgba_root)


def test_cli_fit_dataset_densify_checkpoint_resume_and_eval(rgba_root, tmp_path, capsys):
    """cli fit --dataset with density control (every step from step 1, zero
    threshold) to 4 steps with a checkpoint dir, resumed to 6 (2 more steps,
    the resume logged), then cli eval of the fit and of the initial scene
    (the same fit at 0 steps) on the held-out split and over orbit poses."""
    ck, fit, init = str(tmp_path / "ck"), str(tmp_path / "fit.ply"), str(tmp_path / "init.ply")
    common = ["fit", "--dataset", rgba_root, "--order", "window", "--sh-degree", "1",
              "--densify", "--densify-from", "1", "--densify-every", "2", "--densify-until", "4",
              "--densify-grad-threshold", "0", "--fit-gaussians", "100", "--capacity", "200",
              "--optimizer", "3dgs", "--loss", "dssim_l1", "--device", "cpu"]
    last = lambda: json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main([*common, "--steps", "0", "-o", init])
    res = last()
    assert res["steps_run"] == 0 and res["loss_first"] is None and res["alive"] == 100
    cli.main([*common, "--steps", "4", "--checkpoint-dir", ck, "-o", fit])
    first = last()
    assert first["views"] == 3 and first["steps_run"] == 4 and first["alive"] > 100
    assert np.isfinite(first["loss_first"]) and np.isfinite(first["loss_last"])
    assert checkpoint_steps(ck) and max(checkpoint_steps(ck)) == 4
    cli.main([*common, "--steps", "6", "--checkpoint-dir", ck, "-o", fit])
    out, err = capsys.readouterr()
    second = json.loads(out.strip().splitlines()[-1])
    assert f"resumed from {ck} at step 4" in err and second["steps_run"] == 2
    assert max(checkpoint_steps(ck)) == 6
    for against in (fit, init):
        cli.main(["eval", "--dataset", rgba_root, "--split", "test", "--sh-degree", "1",
                  "--against", against, "--device", "cpu"])
        res = last()
        assert res["views"] == 2 and np.isfinite(res["psnr_mean"])
        assert res["psnr_min"] <= res["psnr_mean"]
    cli.main(["eval", "--ply", init, "--against", fit, "--poses", "2", "--width", "24",
              "--height", "16", "--device", "cpu"])
    res = last()
    assert res["poses"] == 2 and np.isfinite(res["psnr_mean"])
