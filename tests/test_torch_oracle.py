"""The port's exact oracle against the JAX package's: ops/composite.py,
models/oracle.py (render_oracle), the rolling-shutter oracle and the mesh
oracle, plus the ports of the JAX suite's oracle and mesh-mode tests
(tests/test_renderers.py TestOracle, TestMeshModes) on the torch oracle,
the torch oracle against the C++ re-derivation of the reference march
(gaussian_ray_tracing_tpu/native) at tests/test_native.py's bars, and the
port's entry points with method="oracle".

Tolerances: the same float32 math in both packages, so the composite is
held at 1e-6 absolute (cumprod association) and the frames at >= 90 dB:
what remains are boundary rays, where XLA's CPU FMA contraction moves a
gaussian's alpha across alpha_min or its event across a segment end
(max abs stated per test). Scenes are JAX's random_scene carried across
with from_numpy; meshes with TriangleMesh.from_numpy."""

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import CameraModel as JModel
from gaussian_ray_tracing_tpu.config import MeshType as JMeshType
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import mesh_tracer as jtracer
from gaussian_ray_tracing_tpu.models.oracle import render_oracle as j_render_oracle
from gaussian_ray_tracing_tpu.models.rolling import render_rolling_oracle as j_rolling_oracle
from gaussian_ray_tracing_tpu.ops.composite import composite_depth_ordered as j_composite
from gaussian_ray_tracing_tpu.scene import mesh as jmesh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as ttracer
from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle, render_rays_oracle
from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
from gaussian_ray_tracing_tpu_torch.models.rolling import render_rolling_oracle
from gaussian_ray_tracing_tpu_torch.ops.composite import composite_depth_ordered
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import TriangleMesh, make_plane, merge_meshes
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
FIELDS = ("means", "scales", "quats", "opacities", "sh")
CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)


def _carry(js) -> GaussianScene:
    return GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                                    js.num_active)


def _assert_frames(got, want, min_psnr=90.0, max_abs=1e-2):
    for k in ("rgb", "alpha"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape
        assert psnr(a, b) >= min_psnr and np.abs(a - b).max() <= max_abs, k


# --- ops/composite.py ---------------------------------------------------------

@pytest.mark.parametrize("hm", [1, 2])
@pytest.mark.parametrize("with_t0", [False, True])
def test_composite_matches_jax(hm, with_t0):
    """Random alphas (half the rows dense enough to cross
    min_transmittance), colours and masks; carry-ins with a quarter of the
    rays already at or below min_transmittance."""
    rng = np.random.default_rng(3 + hm)
    R, M = 64, 48
    alphas = rng.uniform(0.0, 0.99, (R, M)).astype(np.float32)
    alphas[: R // 2] *= 0.03  # sparse rows that do not terminate
    colors = rng.uniform(0.0, 1.2, (R, M, 3)).astype(np.float32)
    valid = rng.uniform(size=(R, M)) < 0.8
    t0 = None
    if with_t0:
        t0 = rng.uniform(0.05, 1.0, R).astype(np.float32)
        t0[::4] = rng.uniform(0.0, 1e-3, R // 4).astype(np.float32)
    kw = dict(alpha_min=0.01, min_transmittance=1e-3, hit_multiplicity=hm)
    want = j_composite(alphas, colors, valid, **kw, t0=t0)
    got = composite_depth_ordered(torch.from_numpy(alphas), torch.from_numpy(colors),
                                  torch.from_numpy(valid), **kw,
                                  t0=None if t0 is None else torch.from_numpy(t0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    t_final = got[2].numpy()
    assert (t_final <= 1e-3).any() and (t_final > 0.2).any()  # both kinds of row
    if with_t0:  # terminated carry-ins keep t0 and add nothing
        dead = t0 <= 1e-3
        assert np.array_equal(t_final[dead], t0[dead]) and not got[0].numpy()[dead].any()


# --- models/oracle.py -----------------------------------------------------------

@pytest.fixture(scope="module")
def scene3000():
    js = j_random_scene(3000, seed=11)
    return js, _carry(js)


@pytest.mark.parametrize("model,hm,sh", [("pinhole", 1, 0), ("fisheye", 2, 3)])
def test_render_oracle_matches_jax(scene3000, model, hm, sh):
    """96x64, 3000 gaussians: >= 90 dB and max abs <= 1e-3 on rgb and
    alpha (boundary rays only; the fisheye ring blanked in both)."""
    js, ts = scene3000
    kw = dict(hit_multiplicity=hm, sh_degree=sh)
    want = j_render_oracle(js, JCamera.create(**CAM), JConfig(**kw, camera_model=JModel(model)))
    got = render_oracle(ts, Camera.create(**CAM),
                        RenderConfig(**kw, camera_model=CameraModel(model)))
    _assert_frames(got, want, max_abs=1e-3)
    assert float(got["alpha"].max()) > 0.9


def test_oracle_matches_cpp_rederivation():
    """tests/test_native.py's bars for the C++ re-derivation of the
    reference march: > 60 dB at hm 1, > 45 dB at hm 2 (the closed form
    1-(1-a)^2 against the reference's re-checked double pass)."""
    from gaussian_ray_tracing_tpu.cameras import generate_rays
    from gaussian_ray_tracing_tpu.native.bindings import ref_render_native

    js = j_random_scene(1500, seed=5)
    ts = _carry(js)
    kw = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=48, height=32)
    for hm, bar in ((1, 60.0), (2, 45.0)):
        origins, dirs, _ = generate_rays(JCamera.create(**kw), JConfig(hit_multiplicity=hm))
        got = ref_render_native(js, np.asarray(origins), np.asarray(dirs),
                                JConfig(hit_multiplicity=hm))
        if got is None:
            pytest.skip("native toolchain unavailable")
        rgb_cpp = np.clip(got[0], 0.0, 1.0).reshape(32, 48, 3)
        ours = render_oracle(ts, Camera.create(**kw), RenderConfig(hit_multiplicity=hm))
        assert psnr(ours["rgb"].numpy(), rgb_cpp) > bar, hm


@pytest.mark.parametrize("model", ["pinhole", "fisheye"])
def test_rolling_oracle_matches_jax(model):
    """A moving camera pair (eye +0.05 in x, lookat +0.02 in y over the
    readout), 64x48, 1500 gaussians: >= 90 dB, max abs <= 1e-3."""
    js = j_random_scene(1500, seed=5)
    pose0 = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=48)
    pose1 = dict(pose0, eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.02, 0.0))
    cfg = dict(hit_multiplicity=1, sh_degree=1)
    want = j_rolling_oracle(js, JCamera.create(**pose0), JCamera.create(**pose1),
                            JConfig(**cfg, camera_model=JModel(model)))
    got = render_rolling_oracle(_carry(js), Camera.create(**pose0), Camera.create(**pose1),
                                RenderConfig(**cfg, camera_model=CameraModel(model)))
    _assert_frames(got, want, max_abs=1e-3)
    still = render_oracle(_carry(js), Camera.create(**pose0),
                          RenderConfig(**cfg, camera_model=CameraModel(model)))
    assert psnr(got["rgb"].numpy(), still["rgb"].numpy()) < 60.0  # the rows really move


# --- the mesh oracle --------------------------------------------------------------

MESH_CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=48, height=32)
MESH_CFG = dict(hit_multiplicity=1)


def _jmesh(kind):
    pos = np.array([0.0, 0.0, 1.2], np.float32)
    return jmesh.make_plane(pos) if kind == "plane" else jmesh.make_sphere(pos, tess_u=12,
                                                                           tess_v=6)


def _tmesh(jm) -> TriangleMesh:
    return TriangleMesh.from_numpy({k: np.asarray(getattr(jm, k)) for k in
                                    ("vertices", "normals", "faces", "transform")}, jm.num_faces)


@pytest.fixture(scope="module")
def scene1200():
    js = j_random_scene(1200, seed=4)
    return js, _carry(js)


@pytest.mark.parametrize("kind,mt", [("plane", "MIRROR"), ("plane", "GLASS"), ("plane", "NORMAL"),
                                     ("sphere", "GLASS")])
def test_mesh_oracle_matches_jax(scene1200, kind, mt):
    """render_with_mesh_oracle, 48x32, 1200 gaussians, loop_bound 3: >= 90
    dB and max abs <= 1e-2 (a boundary ray's gate flip, carried through
    the bounces)."""
    js, ts = scene1200
    jm = _jmesh(kind)
    want = jtracer.render_with_mesh_oracle(js, jm, JCamera.create(**MESH_CAM),
                                           JConfig(mesh_type=JMeshType[mt], **MESH_CFG),
                                           loop_bound=3)
    got = ttracer.render_with_mesh_oracle(ts, _tmesh(jm), Camera.create(**MESH_CAM),
                                          RenderConfig(mesh_type=MeshType[mt], **MESH_CFG),
                                          loop_bound=3)
    _assert_frames(got, want)
    assert float(got["alpha"].max()) > 0.5


# --- ports of tests/test_renderers.py TestOracle --------------------------------

def single_gaussian_scene(pos=(0.0, 0.0, 0.0), scale=0.3, opacity=0.9, color_dc=2.0):
    sh = np.zeros((1, 16, 3), np.float32)
    sh[0, 0] = color_dc
    return GaussianScene.from_activated(
        means=np.array([pos], np.float32), scales=np.full((1, 3), scale, np.float32),
        quats=np.array([[1.0, 0, 0, 0]], np.float32), opacities=np.array([opacity], np.float32),
        sh=sh, pad_to=256)


CFG1 = RenderConfig(hit_multiplicity=1)
CAM64 = dict(eye=(0, 0, 3), lookat=(0, 0, 0), width=64, height=64)
CENTER_RAY = (torch.tensor([[0.0, 0.0, 3.0]]), torch.tensor([[0.0, 0.0, -1.0]]))


def test_single_gaussian_center_bright():
    out = render_oracle(single_gaussian_scene(), Camera.create(**CAM64), CFG1)
    assert float(out["rgb"][32, 32].min()) > 0.3  # centre covered
    assert float(out["rgb"][0, 0].max()) < 1e-3  # corner empty
    assert float(out["alpha"][32, 32]) > 0.5


@pytest.mark.parametrize("hm,want", [(1, 0.7), (2, 1 - 0.3**2)])
def test_alpha_analytic_and_hit_multiplicity(hm, want):
    """The centre ray's alpha is min(0.99, opacity * resp) = 0.7 for one
    gaussian (resp = 1), and 1 - 0.3^2 with two hull hits."""
    scene = single_gaussian_scene(opacity=0.7)
    _, density, _ = render_rays_oracle(scene, *CENTER_RAY, RenderConfig(hit_multiplicity=hm))
    np.testing.assert_allclose(float(density[0]), want, rtol=1e-5)


def test_depth_ordering():
    """The nearer gaussian composites first: front red over back green."""
    sh = np.zeros((2, 16, 3), np.float32)
    sh[0, 0] = [10, -10, -10]  # red, at z=1 (nearer the eye at z=3)
    sh[1, 0] = [-10, 10, -10]  # green, at z=-1
    scene = GaussianScene.from_activated(
        means=np.array([[0, 0, 1], [0, 0, -1]], np.float32),
        scales=np.full((2, 3), 0.2, np.float32),
        quats=np.array([[1, 0, 0, 0]] * 2, np.float32),
        opacities=np.array([0.6, 0.9], np.float32), sh=sh, pad_to=256)
    rgb, _, _ = render_rays_oracle(scene, *CENTER_RAY, CFG1)
    # red at T = 1 * 0.6, green at T = 0.4 * 0.9
    assert float(rgb[0, 0]) > float(rgb[0, 1]) > 0.0


def test_behind_camera_invisible():
    out = render_oracle(single_gaussian_scene(pos=(0, 0, 10)), Camera.create(**CAM64), CFG1)
    assert float(out["rgb"].max()) < 1e-5


def test_fisheye_render():
    out = render_oracle(single_gaussian_scene(), Camera.create(**CAM64),
                        CFG1.replace(camera_model=CameraModel.FISHEYE))
    assert float(out["rgb"][32, 32].min()) > 0.2
    assert not out["rgb"][0, 0].any()  # blanked corner


# --- ports of tests/test_renderers.py TestMeshModes on the mesh oracle --------------

CAM48 = dict(eye=(0, 0, 3), lookat=(0, 0, 0), width=48, height=48)


def _modes_setup():
    return (single_gaussian_scene(pos=(0.0, 0.0, -1.0), scale=0.25, opacity=0.95),
            Camera.create(**CAM48), make_plane(position=(0.0, 0.0, 1.0), width=4.0, height=4.0))


def _oracle(scene, cam, cfg, mesh):
    return render(scene, cam, cfg, mesh=mesh, method="oracle")


def test_normal_mode_shows_normal_color():
    scene, cam, mesh = _modes_setup()
    out = _oracle(scene, cam, CFG1.replace(mesh_type=MeshType.NORMAL), mesh)
    # plane normal +z -> colour (0.5, 0.5, 1.0) where no gaussian is in front
    np.testing.assert_allclose(out["rgb"][2, 2].numpy(), [0.5, 0.5, 1.0], atol=0.05)


def test_mirror_mode_runs():
    scene, cam, mesh = _modes_setup()
    out = _oracle(scene, cam, CFG1.replace(mesh_type=MeshType.MIRROR), mesh)
    assert bool(torch.isfinite(out["rgb"]).all())


def test_mirror_reflects_gaussian():
    # a gaussian BEHIND the camera; the mirror in front reflects it back
    scene = single_gaussian_scene(pos=(0.0, 0.0, 7.0), scale=0.4, opacity=0.95)
    cam = Camera.create(**CAM48)
    mesh = make_plane(position=(0.0, 0.0, -1.0), width=6.0, height=6.0)
    cfg = CFG1.replace(mesh_type=MeshType.MIRROR)
    assert float(render(scene, cam, cfg, method="oracle")["rgb"].max()) < 1e-4
    assert float(_oracle(scene, cam, cfg, mesh)["rgb"][24, 24].max()) > 0.1


def test_glass_mode_runs():
    scene, cam, mesh = _modes_setup()
    rgb = _oracle(scene, cam, CFG1.replace(mesh_type=MeshType.GLASS), mesh)["rgb"]
    assert bool(torch.isfinite(rgb).all())
    assert float(rgb[24, 24].max()) > 0.1  # glass is transparent: the gaussian shows


def test_per_face_types_override_global():
    scene, cam, mesh = _modes_setup()
    for t in (MeshType.NORMAL, MeshType.MIRROR, MeshType.GLASS):
        want = _oracle(scene, cam, CFG1.replace(mesh_type=t), mesh)
        other = MeshType.MIRROR if t != MeshType.MIRROR else MeshType.GLASS
        got = _oracle(scene, cam, CFG1.replace(mesh_type=other), mesh.with_type(t))
        np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"].numpy(), atol=1e-5)


def test_mixed_types_in_one_scene():
    scene = single_gaussian_scene(pos=(0.0, 0.0, 7.0), scale=0.4, opacity=0.95)
    cam = Camera.create(**CAM48)
    left = make_plane(position=(-1.5, 0.0, -1.0), width=3.0, height=6.0)
    right = make_plane(position=(1.5, 0.0, -1.0), width=3.0, height=6.0)
    mixed = merge_meshes([left.with_type(MeshType.MIRROR), right.with_type(MeshType.NORMAL)])
    out = _oracle(scene, cam, CFG1, mixed)["rgb"].numpy()
    both = merge_meshes([left, right])
    mirror_only = _oracle(scene, cam, CFG1.replace(mesh_type=MeshType.MIRROR), both)["rgb"]
    normal_only = _oracle(scene, cam, CFG1.replace(mesh_type=MeshType.NORMAL), both)["rgb"]
    # world +x maps to image LEFT: the left half sees the NORMAL plane
    np.testing.assert_allclose(out[:, :20], normal_only.numpy()[:, :20], atol=1e-5)
    np.testing.assert_allclose(out[:, 28:], mirror_only.numpy()[:, 28:], atol=1e-5)


# --- the port's entry points ------------------------------------------------------

def test_render_method_oracle_entry_points():
    """render(method="oracle") on a CPU scene is render_oracle's frame, with
    an empty aux; GaussianRayTracer keeps its pair-capacity bucket."""
    js = j_random_scene(800, seed=5)
    ts = _carry(js)
    cam = Camera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=40, height=24)
    cfg = RenderConfig(hit_multiplicity=1)
    want = render_oracle(ts, cam, cfg)
    out = render(ts, cam, cfg, method="oracle", return_aux=True)
    assert out["aux"] == {}
    assert torch.equal(out["rgb"], want["rgb"]) and torch.equal(out["alpha"], want["alpha"])
    tracer = GaussianRayTracer(scene=ts, config=cfg)
    tracer.set_size(40, 24)
    tracer.update_camera(cam)
    tracer.render(method="plain")
    bucket = tracer._pair_capacity
    assert torch.equal(tracer.render(method="oracle")["rgb"], want["rgb"])
    assert tracer._pair_capacity == bucket
    tracer.create_plane(mesh_type="normal")
    out = tracer.render(method="oracle")
    assert out["rgb"].shape == (24, 40, 3) and not torch.equal(out["rgb"], want["rgb"])
    with pytest.raises(ValueError):
        render(ts, cam, cfg, method="exact")
