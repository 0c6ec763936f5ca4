"""The port's native C++ core (gaussian_ray_tracing_tpu_torch/native):
every test of tests/test_native.py on the port's own binding and sources,
that it builds under build/native/ (never beside its sources), and that
no native module imports jax or the JAX package."""

import os
import subprocess
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu_torch.native import bindings as B

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib_ok():
    if not B.build() or not B.available():
        pytest.skip("native toolchain unavailable")
    return True


def _write_ply(path, rng, n):
    from gaussian_ray_tracing_tpu_torch.scene.ply import save_ply

    arrays = (rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32),
              rng.normal(size=(n, 4)).astype(np.float32), rng.normal(size=(n,)).astype(np.float32),
              rng.normal(size=(n, 16, 3)).astype(np.float32))
    save_ply(str(path), *arrays)
    return arrays


class TestNativePly:
    def test_roundtrip_exact(self, lib_ok, tmp_path):
        from gaussian_ray_tracing_tpu_torch.scene.ply import read_ply_raw

        means, _, q, o, sh = _write_ply(tmp_path / "a.ply", np.random.default_rng(0), 5000)
        with mock.patch.object(B, "ply_read_native", wraps=B.ply_read_native) as native:
            cols = read_ply_raw(str(tmp_path / "a.ply"))  # the native fast path
        assert native.call_count == 1
        np.testing.assert_array_equal(cols["x"], means[:, 0])
        np.testing.assert_array_equal(cols["opacity"], o)
        np.testing.assert_array_equal(cols["rot_3"], q[:, 3])
        np.testing.assert_array_equal(cols["f_rest_29"], sh[:, 15, 1])

    def test_native_matches_numpy_reader(self, lib_ok, tmp_path):
        from gaussian_ray_tracing_tpu_torch.scene import ply as P

        _write_ply(tmp_path / "b.ply", np.random.default_rng(1), 257)
        native = B.ply_read_native(str(tmp_path / "b.ply"))
        assert native is not None
        with mock.patch.object(B, "_load", return_value=None):  # force the numpy reader
            assert B.ply_read_native(str(tmp_path / "b.ply")) is None
            pure = P.read_ply_raw(str(tmp_path / "b.ply"))
        assert list(native) == list(pure)
        for k in pure:
            np.testing.assert_array_equal(native[k], pure[k])

    def test_native_write_reads_back(self, lib_ok, tmp_path):
        cols = {"x": np.arange(5, dtype=np.float32), "opacity": torch.linspace(0, 1, 5)}
        assert B.ply_write_native(str(tmp_path / "c.ply"), cols)
        back = B.ply_read_native(str(tmp_path / "c.ply"))
        np.testing.assert_array_equal(back["x"], cols["x"])
        np.testing.assert_array_equal(back["opacity"], cols["opacity"].numpy())


class TestNativeMorton:
    def test_matches_numpy(self, lib_ok):
        rng = np.random.default_rng(2)
        pos = rng.uniform(-1, 1, size=(1000, 3)).astype(np.float32)
        codes = B.morton3d(pos)
        assert codes.shape == (1000,) and codes.dtype == np.uint64
        with mock.patch.object(B, "_load", return_value=None):
            assert np.array_equal(B.morton3d(torch.from_numpy(pos)), codes)
        # locality: neighbours in sorted order are close
        pts = pos[np.argsort(codes)]
        adj = np.linalg.norm(np.diff(pts, axis=0), axis=-1).mean()
        rnd = np.linalg.norm(pts[:-1] - pts[rng.permutation(999)], axis=-1).mean()
        assert adj < 0.6 * rnd

    def test_argsort_u64(self, lib_ok):
        keys = np.random.default_rng(3).integers(0, 1 << 62, size=10_000, dtype=np.uint64)
        keys[::7] = keys[0]  # ties keep their order (stable)
        perm = B.argsort_u64(keys)
        assert np.all(np.diff(keys[perm]) >= 0)
        assert np.array_equal(perm, np.argsort(keys, kind="stable"))


class TestReferenceRederivation:
    """The port's oracle against refmarch.cpp, the independently written
    sequential C++ re-derivation of the reference march, at the bars of
    tests/test_native.py."""

    @pytest.mark.parametrize("hm,min_psnr", [(1, 60.0), (2, 45.0)])
    def test_oracle_matches_cpp_rederivation(self, hm, min_psnr):
        from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
        from gaussian_ray_tracing_tpu_torch.config import RenderConfig
        from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle
        from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

        cfg = RenderConfig(hit_multiplicity=hm)
        scene = random_scene(1500, seed=5)
        cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=48, height=32)
        origins, dirs, _ = generate_rays(cam, cfg)
        got = B.ref_render_native(scene, origins, dirs, cfg)
        if got is None:
            pytest.skip("native toolchain unavailable")
        rgb_cpp = np.clip(got[0], 0.0, 1.0)
        rgb = render_oracle(scene, cam, cfg)["rgb"].numpy().reshape(-1, 3)
        mse = float(np.mean((rgb_cpp - rgb) ** 2))
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) > min_psnr


def test_builds_under_build_native(lib_ok):
    """Libraries land in build/native/ of the checkout, named by a hash of
    their source and flags; nothing is written beside the sources."""
    path = B.library_path("grtcore", B.CORE_FLAGS)
    assert path.parent == B.BUILD_DIR
    assert B.BUILD_DIR == B.SRC_DIR.parent.parent / "build" / "native"
    assert path.is_file() and path.name.startswith("libgrtcore_")
    assert not [n for n in os.listdir(B.SRC_DIR) if n.endswith(".so")]
    assert B.library_path("grtcore", B.CORE_FLAGS + ("-g",)) != path


def test_native_modules_import_no_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import gaussian_ray_tracing_tpu_torch.native\n"
        "from gaussian_ray_tracing_tpu_torch.native import bindings\n"
        "import gaussian_ray_tracing_tpu_torch.scene.ply\n"
        "bindings.morton3d([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "assert not any(m == 'gaussian_ray_tracing_tpu' or m.startswith(\n"
        "    'gaussian_ray_tracing_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
