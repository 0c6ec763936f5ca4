"""The mesh-bounce slice: the port's mesh tracer on its plain kernel versions
against the JAX package's render_with_mesh_fast and
render_with_mesh_planar_mirror (Pallas in interpret mode) and its exact
oracle, plus the port's own entry points (render(mesh=...), the tracer's
primitives, cli render) and the ports of the JAX suite's mesh tests.

The configuration is the JAX suite's TestMeshFast: 48x32, random_scene(
1200, seed=4), loop_bound=2, window order at c=256, skip 1e-3, the plane
at z=1.2 as NORMAL, MIRROR and GLASS, plus a 24x12 GLASS sphere there and
the plane as GLASS with two Morton blocks per kernel chunk. Bars: port vs
the JAX fast paths >= 50 dB on rgb and alpha with equal block_dropped; on
the planes vs the JAX oracle >= 40 dB (the JAX suite's own bar); the
port's planar-mirror path vs its block path >= 55 dB, alpha atol 2e-3.
The scene and the meshes are carried across with from_numpy."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import MeshType as JMeshType
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import mesh_tracer as jtracer
from gaussian_ray_tracing_tpu.scene import mesh as jmesh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import MeshType, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as ttracer
from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import (
    TriangleMesh, load_obj, make_plane, make_sphere, merge_meshes,
)
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FIELDS = ("means", "scales", "quats", "opacities", "sh")
CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=48, height=32)
MESH_CFG = dict(hit_multiplicity=1, order="window", march_chunk=256, max_per_tile=4096,
                chunk_skip_transmittance=1e-3)
# case -> (mesh, mesh type, extra config)
CASES = {
    "plane_normal": ("plane", "NORMAL", {}),
    "plane_mirror": ("plane", "MIRROR", {}),
    "plane_glass": ("plane", "GLASS", {}),
    "sphere_glass": ("sphere", "GLASS", {}),
    "plane_glass_bsub2": ("plane", "GLASS", dict(march_chunk=128, bounce_blocks_per_chunk=2)),
}


def _jmesh(kind):
    pos = np.array([0.0, 0.0, 1.2], np.float32)
    return jmesh.make_plane(pos) if kind == "plane" else jmesh.make_sphere(pos, tess_u=24,
                                                                           tess_v=12)


def _carry(jm) -> TriangleMesh:
    return TriangleMesh.from_numpy({k: np.asarray(getattr(jm, k)) for k in
                                    ("vertices", "normals", "faces", "transform")},
                                   jm.num_faces)


@pytest.fixture(scope="module")
def scenes():
    js = j_random_scene(1200, seed=4)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS},
                                  js.num_active)
    return js, ts


def _np(out):
    return {k: np.asarray(out[k]) for k in ("rgb", "alpha")}


@pytest.fixture(scope="module")
def jax_fast(scenes):
    """The JAX fast path on every case (interpret mode), once per module."""
    js, _ = scenes
    out = {}
    for name, (kind, mt, extra) in CASES.items():
        cfg = JConfig(mesh_type=JMeshType[mt], **{**MESH_CFG, **extra})
        res = jtracer.render_with_mesh_fast(js, _jmesh(kind), JCamera.create(**CAM), cfg,
                                            loop_bound=2, interpret=True)
        out[name] = {**_np(res), "block_dropped": int(res["aux"]["block_dropped"])}
    return out


@pytest.fixture(scope="module")
def port_fast(scenes):
    _, ts = scenes
    out = {}
    for name, (kind, mt, extra) in CASES.items():
        cfg = RenderConfig(mesh_type=MeshType[mt], **{**MESH_CFG, **extra})
        res = ttracer.render_with_mesh_fast(ts, _carry(_jmesh(kind)), Camera.create(**CAM), cfg,
                                            loop_bound=2, use_kernels=False)
        out[name] = {**{k: res[k].numpy() for k in ("rgb", "alpha")}, **res["aux"]}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_fast_path_matches_jax(jax_fast, port_fast, name):
    want, got = jax_fast[name], port_fast[name]
    assert got["rgb"].shape == (32, 48, 3) and np.isfinite(got["rgb"]).all()
    assert psnr(got["rgb"], want["rgb"]) >= 50.0
    assert psnr(got["alpha"], want["alpha"]) >= 50.0
    assert got["block_dropped"] == want["block_dropped"]
    assert got["pair_dropped"] == 0
    assert float(got["alpha"].max()) > 0.5


def test_planar_mirror_matches_jax(scenes):
    js, ts = scenes
    jm = _jmesh("plane")
    cfg = RenderConfig(mesh_type=MeshType.MIRROR, **MESH_CFG)
    plane = ttracer.planar_mirror_plane(_carry(jm), cfg)
    jplane = jtracer.planar_mirror_plane(jm, JConfig(mesh_type=JMeshType.MIRROR, **MESH_CFG))
    for k in plane:
        assert np.array_equal(plane[k], jplane[k]), k
    want = jtracer.render_with_mesh_planar_mirror(
        js, JCamera.create(**CAM), JConfig(mesh_type=JMeshType.MIRROR, **MESH_CFG),
        n=tuple(float(x) for x in jplane["n"]), d=float(jplane["d"]),
        b1=tuple(float(x) for x in jplane["b1"]), b2=tuple(float(x) for x in jplane["b2"]),
        lo1=float(jplane["lo1"]), hi1=float(jplane["hi1"]), lo2=float(jplane["lo2"]),
        hi2=float(jplane["hi2"]), interpret=True)
    got = ttracer.render_with_mesh(ts, _carry(jm), Camera.create(**CAM), cfg, use_kernels=False)
    assert "block_dropped" not in got["aux"] and got["aux"]["pair_dropped"] == 0
    for k in ("rgb", "alpha"):
        assert psnr(got[k].numpy(), np.asarray(want[k])) >= 50.0


@pytest.mark.parametrize("mt", ["NORMAL", "MIRROR", "GLASS"])
def test_fast_path_vs_jax_oracle(scenes, port_fast, mt):
    """The JAX suite's own bar for its fast path vs the exact oracle."""
    js, _ = scenes
    cfg = JConfig(mesh_type=JMeshType[mt], **MESH_CFG)
    ref = jtracer.render_with_mesh_oracle(js, _jmesh("plane"), JCamera.create(**CAM), cfg,
                                          loop_bound=2)
    assert psnr(port_fast[f"plane_{mt.lower()}"]["rgb"], np.asarray(ref["rgb"])) >= 40.0


def test_planar_mirror_matches_block_path():
    """Port of TestPlanarMirrorFastPath.test_matches_block_path: the
    reflected-frame path computes the block path's image."""
    cfg = RenderConfig(hit_multiplicity=1, order="window", march_chunk=64,
                       mesh_type=MeshType.MIRROR, chunk_skip_transmittance=1e-3)
    scene = random_scene(1200, seed=3)
    cam = Camera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    mesh = make_plane(position=(0.0, -0.1, 0.8), width=1.2, height=1.0)
    assert ttracer.planar_mirror_plane(mesh, cfg) is not None
    a = ttracer.render_with_mesh_fast(scene, mesh, cam, cfg, use_kernels=False)
    b = ttracer.render_with_mesh(scene, mesh, cam, cfg, use_kernels=False)
    assert "block_dropped" in a["aux"] and "block_dropped" not in b["aux"]
    assert psnr(a["rgb"].numpy(), b["rgb"].numpy()) > 55.0
    np.testing.assert_allclose(a["alpha"].numpy(), b["alpha"].numpy(), atol=2e-3)
    # a loop_bound override takes the block path, as in the JAX package
    c = ttracer.render_with_mesh(scene, mesh, cam, cfg, use_kernels=False, loop_bound=4)
    assert torch.equal(c["rgb"], a["rgb"])


def test_rejects_non_planar_and_non_mirror():
    cfg = RenderConfig(mesh_type=MeshType.MIRROR)
    assert ttracer.planar_mirror_plane(make_sphere(tess_u=24, tess_v=12), cfg) is None
    plane = make_plane()
    assert ttracer.planar_mirror_plane(plane, cfg.replace(mesh_type=MeshType.GLASS)) is None
    assert ttracer.planar_mirror_plane(plane, cfg) is not None
    assert ttracer.planar_mirror_plane(plane.with_type(MeshType.NORMAL), cfg) is None


# --- ports of tests/test_renderers.py TestMeshModes (render(mesh=...)) ------

def single_gaussian_scene(pos=(0.0, 0.0, 0.0), scale=0.3, opacity=0.9, color_dc=2.0):
    sh = np.zeros((1, 16, 3), np.float32)
    sh[0, 0] = color_dc
    return GaussianScene.from_activated(
        means=np.array([pos], np.float32), scales=np.full((1, 3), scale, np.float32),
        quats=np.array([[1.0, 0, 0, 0]], np.float32), opacities=np.array([opacity], np.float32),
        sh=sh, pad_to=256)


CFG1 = RenderConfig(hit_multiplicity=1)
CAM48 = dict(eye=(0, 0, 3), lookat=(0, 0, 0), width=48, height=48)


def _modes_setup():
    return (single_gaussian_scene(pos=(0.0, 0.0, -1.0), scale=0.25, opacity=0.95),
            Camera.create(**CAM48), make_plane(position=(0.0, 0.0, 1.0), width=4.0, height=4.0))


def test_normal_mode_shows_normal_color():
    scene, cam, mesh = _modes_setup()
    out = render(scene, cam, CFG1.replace(mesh_type=MeshType.NORMAL), mesh=mesh)
    # plane normal +z -> colour (0.5, 0.5, 1.0) where no gaussian is in front
    np.testing.assert_allclose(out["rgb"][2, 2].numpy(), [0.5, 0.5, 1.0], atol=0.05)


def test_mirror_mode_runs():
    scene, cam, mesh = _modes_setup()
    out = render(scene, cam, CFG1.replace(mesh_type=MeshType.MIRROR), mesh=mesh)
    assert bool(torch.isfinite(out["rgb"]).all())


def test_mirror_reflects_gaussian():
    # gaussian BEHIND the camera; the mirror in front reflects it back
    scene = single_gaussian_scene(pos=(0.0, 0.0, 7.0), scale=0.4, opacity=0.95)
    cam = Camera.create(**CAM48)
    mesh = make_plane(position=(0.0, 0.0, -1.0), width=6.0, height=6.0)
    cfg = CFG1.replace(mesh_type=MeshType.MIRROR)
    out = render(scene, cam, cfg, mesh=mesh)
    assert float(render(scene, cam, cfg)["rgb"].max()) < 1e-4  # invisible without it
    assert float(out["rgb"][24, 24].max()) > 0.1
    # the same through the block path (a loop_bound override)
    fast = ttracer.render_with_mesh(scene, mesh, cam, cfg, use_kernels=False, loop_bound=2)
    assert float(fast["rgb"][24, 24].max()) > 0.1


def test_glass_mode_runs():
    scene, cam, mesh = _modes_setup()
    out = render(scene, cam, CFG1.replace(mesh_type=MeshType.GLASS), mesh=mesh)
    assert bool(torch.isfinite(out["rgb"]).all())
    # glass is transparent: the gaussian behind it still shows at the centre
    assert float(out["rgb"][24, 24].max()) > 0.1


def test_per_face_types_override_global():
    scene, cam, mesh = _modes_setup()
    for t in (MeshType.NORMAL, MeshType.MIRROR, MeshType.GLASS):
        want = render(scene, cam, CFG1.replace(mesh_type=t), mesh=mesh)
        # a deliberately contradictory global type
        other = MeshType.MIRROR if t != MeshType.MIRROR else MeshType.GLASS
        got = render(scene, cam, CFG1.replace(mesh_type=other), mesh=mesh.with_type(t))
        np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"].numpy(), atol=1e-5)


def test_mixed_types_in_one_scene():
    scene = single_gaussian_scene(pos=(0.0, 0.0, 7.0), scale=0.4, opacity=0.95)
    cam = Camera.create(**CAM48)
    left = make_plane(position=(-1.5, 0.0, -1.0), width=3.0, height=6.0)
    right = make_plane(position=(1.5, 0.0, -1.0), width=3.0, height=6.0)
    mixed = merge_meshes([left.with_type(MeshType.MIRROR), right.with_type(MeshType.NORMAL)])
    out = render(scene, cam, CFG1, mesh=mixed)["rgb"].numpy()
    both = merge_meshes([left, right])
    mirror_only = render(scene, cam, CFG1.replace(mesh_type=MeshType.MIRROR), mesh=both)
    normal_only = render(scene, cam, CFG1.replace(mesh_type=MeshType.NORMAL), mesh=both)
    # world +x maps to image LEFT: the left half sees the NORMAL plane
    np.testing.assert_allclose(out[:, :20], normal_only["rgb"].numpy()[:, :20], atol=1e-5)
    np.testing.assert_allclose(out[:, 28:], mirror_only["rgb"].numpy()[:, 28:], atol=1e-5)


def test_obj_load_and_render(tmp_path):
    """Port of TestObjMesh: the OBJ cube, NORMAL, key order (bounce_order
    stays "window"), through the fast path."""
    from test_torch_mesh import write_cube_obj

    mesh = load_obj(write_cube_obj(tmp_path / "cube.obj"), np.array([0.0, 0.0, 1.0], np.float32))
    assert mesh.faces.shape[0] == 12
    cam = Camera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=48, height=32)
    cfg = RenderConfig(hit_multiplicity=1, order="key", mesh_type=MeshType.NORMAL,
                       max_per_tile=4096)
    out = ttracer.render_with_mesh_fast(random_scene(800, seed=4), mesh, cam, cfg, loop_bound=2,
                                        use_kernels=False)
    rgb = out["rgb"].numpy()
    assert np.isfinite(rgb).all()
    # the cube's front face occludes the scene centre with its normal colour
    assert rgb[16, 24].min() > 0.05


def test_key_bounce_order_and_refusals():
    scene, cam, mesh = _modes_setup()
    cfg = CFG1.replace(mesh_type=MeshType.GLASS, bounce_order="key")
    out = ttracer.render_with_mesh_fast(scene, mesh, cam, cfg, use_kernels=False)
    win = ttracer.render_with_mesh_fast(scene, mesh, cam, cfg.replace(bounce_order="window"),
                                        use_kernels=False)
    assert psnr(out["rgb"].numpy(), win["rgb"].numpy()) >= 40.0  # one gaussian: same order
    # oddeven on the bounced segments and on bounce 0 runs as JAX's does
    # (stream order, the exact event gate: key order's on windowed rays)
    for ported in (dict(bounce_order="oddeven"), dict(order="oddeven")):
        odd = render(scene, cam, cfg.replace(**ported), mesh=mesh)
        assert torch.equal(odd["rgb"], out["rgb"])
    # merge order on bounce 0 and on the bounced segments (one gaussian: the
    # same image as window order)
    merge = ttracer.render_with_mesh_fast(scene, mesh, cam,
                                          cfg.replace(order="merge", bounce_order="merge"),
                                          use_kernels=False)
    assert psnr(merge["rgb"].numpy(), win["rgb"].numpy()) >= 40.0
    from gaussian_ray_tracing_tpu_torch.config import CameraModel

    # SH 1 and fisheye frames trace too (tests/test_torch_mesh_cameras.py
    # holds them against the JAX package): the gaussian's SH 1 coefficients
    # are zero, so SH 1 gives the SH 0 frame; the fisheye corner stays black
    sh1 = render(scene, cam, cfg.replace(sh_degree=1), mesh=mesh)
    np.testing.assert_allclose(sh1["rgb"].numpy(), out["rgb"].numpy(), atol=1e-5)
    fish = render(scene, cam, cfg.replace(camera_model=CameraModel.FISHEYE), mesh=mesh)
    assert not fish["rgb"][0, 0].any() and float(fish["rgb"].max()) > 0.1
    with pytest.raises(RuntimeError):  # the kernels need CUDA tensors
        render(scene, cam, CFG1, mesh=mesh, method="gpu")


def test_tracer_primitives():
    tracer = GaussianRayTracer(scene=random_scene(1000, seed=2), config=CFG1)
    tracer.set_size(48, 32)
    tracer.update_camera(Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0),
                                       width=48, height=32))
    base = tracer.render_rgb8()
    assert tracer.create_plane(mesh_type="normal") == 0
    spawn = 0.75 * np.array([0.0, 0.3, 2.8]) + 0.25 * np.zeros(3)
    np.testing.assert_allclose(tracer.primitives[0].transform[:3, 3].numpy(), spawn, rtol=1e-6)
    plane = tracer.render_rgb8()
    assert not np.array_equal(plane, base)
    assert tracer.create_sphere(tess_u=12, tess_v=6, mesh_type=MeshType.GLASS) == 1
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = (1.0, 0.0, 0.5)  # beside the plane, which hides the centre
    tracer.update_instance_transform(1, xf)
    two = tracer.render_rgb8()
    assert not np.array_equal(two, plane)
    tracer.remove_primitive(1)
    assert np.array_equal(tracer.render_rgb8(), plane)
    tracer.set_render_type("mirror")
    assert tracer.config.mesh_type == MeshType.MIRROR
    tracer.remove_primitive(0)
    assert np.array_equal(tracer.render_rgb8(), base)


def test_cli_render_with_primitives(tmp_path):
    from gaussian_ray_tracing_tpu_torch import cli
    from test_torch_mesh import write_cube_obj

    for flags in (["--add-plane", "--mesh-type", "normal"],
                  ["--add-sphere", "--mesh-type", "glass"],
                  ["--load-obj", write_cube_obj(tmp_path / "cube.obj"), "--mesh-type", "mirror"]):
        out = tmp_path / "frame.png"
        cli.main(["render", "--synthetic", "1500", "--width", "40", "--height", "24",
                  "--device", "cpu", "-o", str(out), *flags])
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        out.unlink()


def test_mesh_path_imports_no_jax():
    """With jax made unimportable, the mesh tracer imports and renders."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gaussian_ray_tracing_tpu_torch.cameras import Camera\n"
        "from gaussian_ray_tracing_tpu_torch.config import MeshType, RenderConfig\n"
        "from gaussian_ray_tracing_tpu_torch.models.renderer import render\n"
        "from gaussian_ray_tracing_tpu_torch.scene.mesh import make_sphere\n"
        "from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene\n"
        "cam = Camera.create(eye=(0, 0.3, 2.8), lookat=(0, 0, 0), width=32, height=32)\n"
        "mesh = make_sphere((0.0, 0.0, 1.0), tess_u=12, tess_v=6).with_type(MeshType.GLASS)\n"
        "out = render(random_scene(500, seed=0), cam, RenderConfig(), mesh=mesh)\n"
        "assert out['rgb'].shape == (32, 32, 3) and float(out['rgb'].max()) > 0\n"
        "assert not any(m == 'gaussian_ray_tracing_tpu' or m.startswith(\n"
        "    'gaussian_ray_tracing_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
