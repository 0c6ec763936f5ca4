"""Mesh bounces at every camera model and SH degree: the port's mesh tracer
on its plain kernel versions against the JAX package's
render_with_mesh_fast and render_with_mesh_planar_mirror (Pallas in
interpret mode) and its exact oracle.

The setup is tests/test_torch_mesh_render.py's: 48x32, random_scene(1200,
seed=4) carried across with from_numpy, loop_bound=2, window order at
c=256, skip 1e-3, the plane and the 24x12 sphere at z=1.2. The cases put a
fisheye camera, an OpenCV camera (-0.25, 0.05, 0, 0) or SH degree 1 and 3
on them (the SH 3 plane also with bounce_order="key"). Bars: port vs the JAX fast
path >= 50 dB on rgb and alpha with equal block_dropped, no dropped pair
and the fisheye corners black; the planar mirror vs JAX's >= 50 dB; the
fisheye and SH 3 planes (window order) vs the JAX oracle >= 40 dB (the JAX suite's own
bar, tests/test_pallas.py:164-190)."""

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.config import CameraModel as JCameraModel
from gaussian_ray_tracing_tpu.config import MeshType as JMeshType
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models import mesh_tracer as jtracer
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType, RenderConfig
from gaussian_ray_tracing_tpu_torch.models import mesh_tracer as ttracer
from gaussian_ray_tracing_tpu_torch.models.renderer import render
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from test_torch_mesh_render import CAM, MESH_CFG, _carry, _jmesh, scenes  # noqa: F401

torch.set_num_threads(1)
FISHEYE = dict(camera_model="FISHEYE")
OPENCV = dict(camera_model="OPENCV", distortion=(-0.25, 0.05, 0.0, 0.0))
# case -> (mesh, mesh type, extra config)
CASES = {
    "fisheye_plane_normal": ("plane", "NORMAL", FISHEYE),
    "fisheye_plane_glass": ("plane", "GLASS", FISHEYE),
    "fisheye_sphere_glass": ("sphere", "GLASS", FISHEYE),
    "opencv_plane_glass": ("plane", "GLASS", OPENCV),
    "sh1_plane_glass": ("plane", "GLASS", dict(sh_degree=1)),
    "sh3_sphere_glass": ("sphere", "GLASS", dict(sh_degree=3)),
    "sh3_plane_glass": ("plane", "GLASS", dict(sh_degree=3)),
    "sh3_plane_glass_key": ("plane", "GLASS", dict(sh_degree=3, bounce_order="key")),
}
# key bounce order composites each bounced chunk in stream (Morton) order:
# 36.2 dB against the oracle at SH 3 and 36.3 dB at SH 0 on this plane, in
# both packages, so the oracle bar holds the planes in window order
ORACLE_CASES = ("fisheye_plane_normal", "fisheye_plane_glass", "sh3_plane_glass")


def _cfg(config_cls, model_cls, mesh_type, extra):
    kw = {**MESH_CFG, **extra}
    if "camera_model" in kw:
        kw["camera_model"] = model_cls[kw["camera_model"]]
    return config_cls(mesh_type=mesh_type, **kw)


def jcfg(mt: str, extra: dict) -> JConfig:
    return _cfg(JConfig, JCameraModel, JMeshType[mt], extra)


def tcfg(mt: str, extra: dict) -> RenderConfig:
    return _cfg(RenderConfig, CameraModel, MeshType[mt], extra)


@pytest.fixture(scope="module")
def jax_fast(scenes):
    """The JAX fast path on every case (interpret mode), once per module."""
    js, _ = scenes
    out = {}
    for name, (kind, mt, extra) in CASES.items():
        res = jtracer.render_with_mesh_fast(js, _jmesh(kind), JCamera.create(**CAM),
                                            jcfg(mt, extra), loop_bound=2, interpret=True)
        out[name] = {"rgb": np.asarray(res["rgb"]), "alpha": np.asarray(res["alpha"]),
                     "block_dropped": int(res["aux"]["block_dropped"])}
    return out


@pytest.fixture(scope="module")
def port_fast(scenes):
    _, ts = scenes
    out = {}
    for name, (kind, mt, extra) in CASES.items():
        res = ttracer.render_with_mesh_fast(ts, _carry(_jmesh(kind)), Camera.create(**CAM),
                                            tcfg(mt, extra), loop_bound=2, use_kernels=False)
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
    if name.startswith("fisheye"):  # outside the image circle: no ray, black
        for y, x in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
            assert not got["rgb"][y, x].any() and got["alpha"][y, x] == 0.0


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_fast_path_vs_jax_oracle(scenes, port_fast, name):
    js, _ = scenes
    kind, mt, extra = CASES[name]
    ref = jtracer.render_with_mesh_oracle(js, _jmesh(kind), JCamera.create(**CAM),
                                          jcfg(mt, extra), loop_bound=2)
    assert psnr(port_fast[name]["rgb"], np.asarray(ref["rgb"])) >= 40.0


def _jax_planar(js, jm, cfg: JConfig):
    pl = jtracer.planar_mirror_plane(jm, cfg)
    vec = lambda k: tuple(float(x) for x in pl[k])
    return jtracer.render_with_mesh_planar_mirror(
        js, JCamera.create(**CAM), cfg, n=vec("n"), d=float(pl["d"]), b1=vec("b1"),
        b2=vec("b2"), lo1=float(pl["lo1"]), hi1=float(pl["hi1"]), lo2=float(pl["lo2"]),
        hi2=float(pl["hi2"]), interpret=True)


@pytest.mark.parametrize("extra", [FISHEYE, OPENCV], ids=["fisheye", "opencv"])
def test_planar_mirror_matches_jax(scenes, extra):
    """render_with_mesh takes the planar path for one planar MIRROR
    rectangle whatever the camera; the mirrored camera keeps the frame's
    camera model, as in the JAX package."""
    js, ts = scenes
    jm = _jmesh("plane")
    want = _jax_planar(js, jm, jcfg("MIRROR", extra))
    got = ttracer.render_with_mesh(ts, _carry(jm), Camera.create(**CAM), tcfg("MIRROR", extra),
                                   use_kernels=False)
    assert "block_dropped" not in got["aux"] and got["aux"]["pair_dropped"] == 0
    for k in ("rgb", "alpha"):
        assert psnr(got[k].numpy(), np.asarray(want[k])) >= 50.0
    if extra is FISHEYE:
        assert not got["rgb"][0, 0].any() and float(got["alpha"][0, 0]) == 0.0


def test_planar_mirror_tangential_p2_matches_jax(scenes):
    """Under OpenCV with p2 != 0 the planar path's pixel flip (x, y) ->
    (W-1-x, y) is not the mirrored camera's exact pixel map (p2 enters xd
    through r2 + 2x^2, even in x), so the planar path and the reference's
    per-ray bounce part (JAX models/mesh_tracer.py:700-729). The port
    reproduces the JAX planar path all the same (>= 50 dB). Against the
    port's mesh oracle (rgb, loop_bound=2) on this setup, at (-0.25, 0.05,
    0, 0.05): the planar path 54.15 dB, the fast path 55.68 dB; at p2 = 0:
    56.79 dB and 55.75 dB. This scene puts little on the mirror's side of
    the plane, so the flip's error stays small here."""
    js, ts = scenes
    jm = _jmesh("plane")
    cam = Camera.create(**CAM)
    got, oracle = {}, {}
    for p2 in (0.05, 0.0):
        extra = dict(camera_model="OPENCV", distortion=(-0.25, 0.05, 0.0, p2))
        cfg = tcfg("MIRROR", extra)
        got[p2] = ttracer.render_with_mesh(ts, _carry(jm), cam, cfg, use_kernels=False)
        ref = ttracer.render_with_mesh_oracle(ts, _carry(jm), cam, cfg, loop_bound=2)["rgb"]
        fast = ttracer.render_with_mesh_fast(ts, _carry(jm), cam, cfg, loop_bound=2,
                                             use_kernels=False)["rgb"]
        oracle[p2] = (psnr(got[p2]["rgb"].numpy(), ref.numpy()), psnr(fast.numpy(), ref.numpy()))
    want = _jax_planar(js, jm, jcfg("MIRROR", dict(camera_model="OPENCV",
                                                   distortion=(-0.25, 0.05, 0.0, 0.05))))
    for k in ("rgb", "alpha"):
        assert psnr(got[0.05][k].numpy(), np.asarray(want[k])) >= 50.0
    measured = {0.05: (54.15, 55.68), 0.0: (56.79, 55.75)}  # the docstring's numbers
    for p2, pair in measured.items():
        assert all(abs(a - b) < 0.05 for a, b in zip(oracle[p2], pair)), (p2, oracle[p2])


def test_glass_plane_before_the_shell_matches_jax_gap():
    """A GLASS plane in front of the scene's shell (z=1.6; random_scene(5000,
    seed=3), 64x64): the bounced rays march the Morton blocks listed near to
    far by centre distance with a window sort inside each chunk only, so
    the fast path is 27.57 dB from the exact oracle, in the JAX package as
    in the port (at z=1.2: 38.60 dB). The port's fast path equals JAX's
    (>= 50 dB) and sits as far from its oracle as JAX's from JAX's."""
    from gaussian_ray_tracing_tpu.scene import mesh as jmesh
    from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
    from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

    js = j_random_scene(5000, seed=3)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in
                                   ("means", "scales", "quats", "opacities", "sh")},
                                  js.num_active)
    cam = dict(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=64)
    jm = jmesh.make_plane(np.array([0.0, 0.0, 1.6], np.float32))
    jc = jcfg("GLASS", {})
    jf = jtracer.render_with_mesh_fast(js, jm, JCamera.create(**cam), jc, loop_bound=2,
                                       interpret=True)["rgb"]
    jo = jtracer.render_with_mesh_oracle(js, jm, JCamera.create(**cam), jc, loop_bound=2)["rgb"]
    tc, tm = tcfg("GLASS", {}), _carry(jm)
    tf = ttracer.render_with_mesh_fast(ts, tm, Camera.create(**cam), tc, loop_bound=2,
                                       use_kernels=False)["rgb"].numpy()
    to = ttracer.render_with_mesh_oracle(ts, tm, Camera.create(**cam), tc,
                                         loop_bound=2)["rgb"].numpy()
    assert psnr(tf, np.asarray(jf)) >= 50.0
    gap_jax, gap_port = psnr(np.asarray(jf), np.asarray(jo)), psnr(tf, to)
    assert abs(gap_jax - 27.57) < 0.05 and abs(gap_port - gap_jax) < 0.05


@pytest.mark.parametrize("extra", [FISHEYE, OPENCV, dict(sh_degree=3)],
                         ids=["fisheye", "opencv", "sh3"])
def test_bounce_table_and_morton_order_match_jax(scenes, extra):
    """prepare_pair_stream(with_table=True) under fisheye and OpenCV and at
    SH 3: the pair stream's tile starts, the bound radius and the table's
    rows (training rows at the config's SH degree, whose scalar columns K1's
    block mode reads) equal the JAX package's stream, bound radius and
    feature table; the Morton block index orders the gaussians as JAX's
    does, so the sorted rows are JAX's Morton-sorted table rows."""
    from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream as j_prepare
    from gaussian_ray_tracing_tpu.ops.blocks import build_block_index as j_block_index
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
    from gaussian_ray_tracing_tpu_torch.ops.blocks import build_block_index
    from gaussian_ray_tracing_tpu_torch.ops.march import scalar_row, train_columns, train_row

    js, ts = scenes
    jc, tc = jcfg("GLASS", extra), tcfg("GLASS", extra)
    jstream, _, jtable, jbound = j_prepare(js, JCamera.create(**CAM), jc, 1 << 16, 256)
    stream, _, _, rows, bound = prepare_pair_stream(ts, Camera.create(**CAM), tc, 1 << 16,
                                                    use_kernels=False, with_table=True)
    deg = tc.sh_degree
    assert rows.shape == (ts.num_gaussians, train_row(deg)) and train_row(deg) == scalar_row(deg)
    np.testing.assert_array_equal(stream.starts.numpy(), np.asarray(jstream.starts))
    np.testing.assert_allclose(bound.numpy(), np.asarray(jbound), rtol=1e-6)
    jt = np.asarray(jtable)
    want = np.stack([np.zeros(len(jt), np.float32) if c is None else jt[:, c]
                     for c in train_columns(deg)], axis=1)
    np.testing.assert_allclose(rows.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    perm = build_block_index(ts.means, bound, block_size=256).perm
    jperm = j_block_index(js.means, jbound, block_size=256).perm
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_fisheye_edge_tiles_bundle_and_cull_conservatively(scenes):
    """Tiles on the fisheye image circle's edge mix live rays with pixels
    that have no ray (d = 0): bundle_rays bounds the live rays only (its
    axis the normalised sum of their directions, each inside the cone), a
    tile without a live ray culls every block, and cull_blocks keeps every
    block whose bounding sphere a live ray of the tile meets."""
    from gaussian_ray_tracing_tpu_torch.cameras import generate_rays
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops.blocks import (
        build_block_index, bundle_rays, cull_blocks,
    )

    _, ts = scenes
    cfg = tcfg("GLASS", FISHEYE)
    cam = Camera.create(**{**CAM, "width": 96, "height": 64})
    _, dirs, _ = generate_rays(cam, cfg)
    d_t = tile_rays(dirs, 16, 16)
    o_t = cam.eye.expand(d_t.shape)
    live = (d_t * d_t).sum(-1) > 0.01
    assert bool((live.any(-1) & ~live.all(-1)).any()) and not bool(live.all())
    b = bundle_rays(o_t, d_t)
    assert torch.equal(b.any_live, live.any(-1))
    total = torch.where(live[..., None], d_t, 0.0).sum(1)
    axis = total / total.norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(b.axis[b.any_live].numpy(), axis[b.any_live].numpy(), atol=1e-6)
    cos = (d_t * b.axis[:, None]).sum(-1)
    assert bool((cos >= b.cos_half[:, None] - 1e-6)[live].all())
    bound = prepare_pair_stream(ts, cam, cfg, 1 << 16, use_kernels=False, with_table=True)[4]
    index = build_block_index(ts.means, bound, block_size=32)
    visible = cull_blocks(index, b, cfg.t_max)
    # brute force: the closest approach (t >= 0) of each live ray to each sphere
    v = index.centers[None, None] - o_t[:, :, None]
    t = torch.clamp((v * d_t[:, :, None]).sum(-1), min=0.0)
    gap = (v - t[..., None] * d_t[:, :, None]).norm(dim=-1)
    meets = ((gap <= index.radii) & live[..., None]).any(1)
    assert bool(meets.any()) and bool((visible | ~meets).all())
    assert not bool(visible[~b.any_live].any())


def test_tracer_mesh_frames_fisheye_sh3_supersampled(scenes):
    """GaussianRayTracer.render with a primitive after set_camera_model(
    "fisheye") at SH 3: the mesh tracer's frame of the merged primitives,
    and with supersample=2 the box filter of the 2x frame, corners black."""
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer

    _, ts = scenes
    tracer = GaussianRayTracer(scene=ts, config=tcfg("GLASS", dict(sh_degree=3)))
    tracer.set_size(48, 32)
    tracer.update_camera(Camera.create(**CAM))
    tracer.set_camera_model("fisheye")
    tracer.update_instance_transform(tracer.create_plane(), _carry(_jmesh("plane")).transform)
    cfg, mesh = tracer.config, tracer.primitives[0]
    one = tracer.render()
    assert torch.equal(one["rgb"], render(ts, tracer.camera, cfg, mesh=mesh)["rgb"])
    two = tracer.render(supersample=2)
    big = Camera.create(**{**CAM, "width": 96, "height": 64})
    want = render(ts, big, cfg, mesh=mesh)["rgb"].reshape(32, 2, 48, 2, 3).mean(dim=(1, 3))
    assert torch.equal(two["rgb"], want)
    assert not two["rgb"][0, 0].any() and float(two["rgb"].max()) > 0.1
    assert psnr(two["rgb"].numpy(), one["rgb"].numpy()) > 20.0


def test_render_takes_every_camera_and_sh_but_oddeven(scenes):
    """render(mesh=...) runs fisheye, OpenCV and SH 1-3 frames, and oddeven
    with them as JAX runs it: bounce 0 and the bounced segments march
    windowed rays, where oddeven and key order are both key order's stream
    order on the exact event gate, so the frames are key order's bit for
    bit; an order JAX does not have is still refused."""
    _, ts = scenes
    cam = Camera.create(**CAM)
    mesh = _carry(_jmesh("plane"))
    for extra in (FISHEYE, OPENCV, dict(sh_degree=2)):
        out = render(ts, cam, tcfg("GLASS", extra), mesh=mesh)
        assert out["rgb"].shape == (32, 48, 3) and bool(torch.isfinite(out["rgb"]).all())
    for ported, key in ((dict(order="oddeven"), dict(order="key")),
                        (dict(bounce_order="oddeven"), dict(bounce_order="key"))):
        odd = render(ts, cam, tcfg("GLASS", {**FISHEYE, **ported}), mesh=mesh)
        want = render(ts, cam, tcfg("GLASS", {**FISHEYE, **key}), mesh=mesh)
        assert torch.equal(odd["rgb"], want["rgb"]) and torch.equal(odd["alpha"], want["alpha"])
    with pytest.raises(NotImplementedError):
        render(ts, cam, tcfg("GLASS", {**FISHEYE, "bounce_order": "sorted"}), mesh=mesh)
