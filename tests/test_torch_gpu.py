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
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
    prepare_pair_stream, prepare_train_stream,
)
from gaussian_ray_tracing_tpu_torch.models.renderer import render, render_diff
from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.ops import scan as tscan
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.train.losses import dssim_l1_loss
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from merge_streams import depth_stream

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


def _train_stream(chunk, order="key", degree=0):
    """The training stream of a 5k scene at 256^2: starts, rows, dirs, eye."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256,
                        height=256, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree)
    stream, rows, _ = prepare_train_stream(scene, cam, cfg)
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], 16, 16)
    return cfg, stream.starts, rows.detach().contiguous(), dirs_t, cam.eye


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_key_march_saved_carries_match_plain(chunk):
    cfg, starts, rows, dirs_t, _ = _train_stream(chunk)
    before = (tmarch.march.launches, tmarch.march.save_tin_launches)
    got = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True)
    torch.cuda.synchronize()
    assert (tmarch.march.launches, tmarch.march.save_tin_launches) == \
        (before[0] + 1, before[1] + 1)
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, chunk, save_tin=True)
    for a, b in zip(got[:2], want[:2]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_backward_kernel_matches_plain_and_is_deterministic(chunk):
    cfg, starts, rows, dirs_t, eye = _train_stream(chunk)
    _, _, tin, base = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
    before = tbwd.march_bwd.launches
    a = tbwd.march_bwd(starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, chunk)
    b = tbwd.march_bwd(starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, chunk)
    torch.cuda.synchronize()
    assert tbwd.march_bwd.launches == before + 2
    assert torch.equal(a, b)  # fixed-order reductions: bit-identical
    want = tbwd.march_bwd_plain(starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, chunk)
    witness = tbwd.march_bwd_plain(starts, rows.double(), dirs_t.double(), eye.double(),
                                   tin.double(), base, d_rgb.double(), d_t.double(), cfg, chunk)
    # per written column: 1e-3 (the JAX suite's bar), 2e-3 on the 9 M
    # columns, whose reference algebra cancels in float32; and K3 as close
    # to the float64 witness as the plain version is
    for i, c in enumerate(tmarch.TRAIN_COLUMNS):
        if c not in tmarch.diff_columns(0):  # quad, radius and pad columns
            assert not a[:, i].any(), i
            continue
        bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
        assert float((a[:, i] - want[:, i]).abs().max() / want[:, i].abs().max()) <= bar, i
        k64, p64 = ((x[:, i] - witness[:, i]).abs().max() for x in (a, want))
        assert float(k64) <= 1.25 * float(p64), i


TRAIN_MODES = [("window", 0, 32), ("window", 0, 128), ("window", 0, 256), ("window", 1, 128),
               ("window", 3, 64), ("window", 3, 128), ("key", 2, 256), ("key", 3, 128),
               ("key", 3, 256)]


@pytest.mark.parametrize("order,degree,chunk", TRAIN_MODES)
def test_training_march_modes_match_plain(order, degree, chunk):
    """K1 with saved carries in window order (scalar response from the eye,
    training sort key) and at SH 1-3 in both orders, against march_plain:
    rgb and T at the quad-path bars, the carries to 1e-4."""
    cfg, starts, rows, dirs_t, eye = _train_stream(chunk, order, degree)
    assert rows.shape[1] == tmarch.train_row(degree)
    kw = {"origins_t": eye.expand(dirs_t.shape).contiguous()} if order == "window" else {}
    before = tmarch.march.launches
    got = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True, **kw)
    torch.cuda.synchronize()
    assert tmarch.march.launches == before + 1
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, chunk, save_tin=True, **kw)
    for a, b in zip(got[:2], want[:2]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("order,degree,chunk", TRAIN_MODES)
def test_training_backward_modes_match_plain(order, degree, chunk):
    """K3's window replay and SH 1-3 modes against march_bwd_plain, per
    written column at 1e-3 (2e-3 on the 9 M columns), as close to the
    float64 witness as the plain version (1.25x), and bit-identical across
    two launches."""
    cfg, starts, rows, dirs_t, eye = _train_stream(chunk, order, degree)
    kw = {"origins_t": eye.expand(dirs_t.shape).contiguous()} if order == "window" else {}
    _, _, tin, base = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True, **kw)
    g = torch.Generator(device="cuda").manual_seed(1)
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
    args = (starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, chunk)
    a, b = tbwd.march_bwd(*args), tbwd.march_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = tbwd.march_bwd_plain(*args)
    witness = tbwd.march_bwd_plain(*(x.double() if torch.is_tensor(x) and x.is_floating_point()
                                     else x for x in args))
    diff = tmarch.diff_columns(degree)
    for i, c in enumerate(tmarch.train_columns(degree)):
        if c not in diff:
            assert not a[:, i].any(), i
            continue
        bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
        assert float((a[:, i] - want[:, i]).abs().max() / want[:, i].abs().max()) <= bar, i
        k64, p64 = ((x[:, i] - witness[:, i]).abs().max() for x in (a, want))
        assert float(k64) <= 1.25 * float(p64), i


@pytest.mark.parametrize("order,degree,model", [("window", 0, "pinhole"), ("window", 3, "fisheye"),
                                                ("key", 3, "opencv")])
def test_render_diff_training_modes_match_plain(order, degree, model):
    """256^2, 5k gaussians: every raw field's gradient through K1 + K3 in
    window order and at SH 3, on the fisheye and OpenCV cameras, against
    the plain path at 1e-3 relative."""
    from gaussian_ray_tracing_tpu_torch.config import CameraModel

    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256,
                        height=256, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, order=order, march_chunk=128, sh_degree=degree,
                       camera_model=CameraModel(model),
                       distortion=(-0.2, 0.05, 0.0, 0.0) if model == "opencv" else ())
    grads = []
    for method in ("gpu", "plain"):
        model_ = GaussianModel.from_scene(scene).requires_grad_(True)
        out = render_diff(model_.activate(), cam, cfg, method=method)
        torch.mean((out["rgb"] - 0.3) ** 2).backward()
        grads.append([p.grad for p in model_.parameters()])
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3


def test_render_diff_backward_kernels_match_plain():
    """256^2, 5k gaussians, L2 to a flat target: every raw field's gradient
    through K1 + K3 against the plain path at 1e-3 relative."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256,
                        height=256, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, order="key")
    grads = []
    for method in ("gpu", "plain"):
        model = GaussianModel.from_scene(scene).requires_grad_(True)
        out = render_diff(model.activate(), cam, cfg, method=method)
        torch.mean((out["rgb"] - 0.3) ** 2).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3


def test_dssim_l1_on_card_matches_cpu():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:128, 0:160].astype(np.float32) / 160.0
    a = (0.4 + 0.2 * np.sin(3 * x + 2 * y))[..., None].repeat(3, -1).astype(np.float32)
    b = (a + 0.01 * rng.normal(size=a.shape)).astype(np.float32)
    cpu = float(dssim_l1_loss(torch.from_numpy(a), torch.from_numpy(b)))
    card = float(dssim_l1_loss(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()))
    assert abs(card - cpu) <= 1e-4 * abs(cpu)


# --- mesh bounces: K4 and K1's segment and block modes ----------------------

def _mesh_case(size=256):
    """A 5k scene, a 36x18 glass sphere in front of it (5 face blocks, so
    the rays leaving it hit its far side) and a camera on the card."""
    from gaussian_ray_tracing_tpu_torch.config import MeshType
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_sphere

    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=size, height=size,
                        device="cuda")
    mesh = make_sphere((0.0, 0.0, 1.6), tess_u=36, tess_v=18, device="cuda")
    return scene, cam, mesh.with_type(MeshType.GLASS)


def _bounce_record(cfg):
    """The K4 and K1 inputs of every bounce of a glass-sphere frame."""
    from gaussian_ray_tracing_tpu_torch.models.mesh_tracer import render_with_mesh_fast

    scene, cam, mesh = _mesh_case()
    record = []
    render_with_mesh_fast(scene, mesh, cam, cfg, record=record)
    assert len(record) >= 2
    return record


def test_closest_hit_kernel_matches_plain():
    """K4 on the glass sphere's bounce-0 (shared origin) and bounce-1 and 2
    (per-ray origins) streams: face ids, t, u and v bit for bit, and the
    kernel's counts of what it ran equal to pretest_stats'."""
    from gaussian_ray_tracing_tpu_torch.ops import tri as ttri

    hits = []
    for rec in _bounce_record(RenderConfig(hit_multiplicity=1, march_chunk=128))[:3]:
        args, kw = rec["k4"]
        before = ttri.closest_hit_blocks.launches
        stats = torch.zeros((args[3].shape[0], 5), dtype=torch.int32, device="cuda")
        got = ttri.closest_hit_blocks(*args, **kw, stats=stats)
        torch.cuda.synchronize()
        assert ttri.closest_hit_blocks.launches == before + 1
        want = ttri.closest_hit_blocks_plain(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))  # face, t, u, v bit for bit
        assert torch.equal(stats, ttri.pretest_stats(*args, kw["origins_t"], kw["bounds"]))
        hits.append(int((want[1] >= 0).sum()))
    assert min(hits[:2]) > 1000  # entering and leaving the sphere


def test_closest_hit_pretest_edge_cases_bit_identical():
    """K4 and the plain version agree bit for bit, and the kernel's counts
    equal pretest_stats', on the pretest tests' rays (from outside, from
    inside, tangent to block spheres, through face edges, grazing faces of
    the sphere and of a tilted plane at 1e-3 to 1e-7 rad and 0; a
    zero-padded tail block), listed near to far and far to near, and on
    tiles whose hits tie at equal t across two listed blocks (the first
    listed wins)."""
    from gaussian_ray_tracing_tpu_torch.ops import tri as ttri
    from test_torch_block_pretest import T_MAX, T_MIN, _faces, _k4_rays, _tilted_plane

    meshes = {"sphere": _faces(), "plane": _tilted_plane()}
    kinds = [("sphere", k) for k in ("outside", "inside", "tangent", "edges")] + [
        (m, f"graze_{m}_{a}") for m in meshes for a in ("1e-3", "1e-5", "1e-6", "1e-7", "0")]
    for mesh, kind in kinds:
        rows, bounds = meshes[mesh]
        nb = bounds.shape[0]
        order = torch.cat([torch.arange(nb), torch.arange(nb - 1, -1, -1)]).to(torch.int32)
        starts = torch.tensor([0, nb * 256, 2 * nb * 256], dtype=torch.int32, device="cuda")
        o, d = (x.reshape(2, 256, 3).cuda() for x in _k4_rays(rows, bounds, kind, n=512))
        args = (starts, order.cuda(), rows.cuda(), d, torch.zeros(3, device="cuda"), T_MIN,
                T_MAX, o)
        before = ttri.closest_hit_blocks.launches
        stats = torch.zeros((2, 5), dtype=torch.int32, device="cuda")
        got = ttri.closest_hit_blocks(*args, bounds=bounds.cuda(), stats=stats)
        torch.cuda.synchronize()
        assert ttri.closest_hit_blocks.launches == before + 1
        want = ttri.closest_hit_blocks_plain(*args)
        assert int((want[1] >= 0).sum()) > 0, kind
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kind
        assert torch.equal(stats, ttri.pretest_stats(*args, bounds.cuda())), kind
    # one triangle in block 0 and block 1: every ray hits both at t = 1
    tri = torch.tensor([-0.5, -0.5, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    trows = torch.zeros((2 * 256, 9))
    trows[17], trows[256 + 3] = tri, tri
    tbounds = ttri.face_bounds(torch.zeros(2, 3), torch.full((2,), 0.75), trows)
    dirs = torch.zeros((2, 32, 3))
    dirs[..., 2] = -1.0
    eye = torch.tensor([-0.25, -0.25, 1.0])
    tstarts = torch.tensor([0, 512, 1024], dtype=torch.int32)
    tblocks = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    targs = [x.cuda() for x in (tstarts, tblocks, trows, dirs, eye)]
    got = ttri.closest_hit_blocks(*targs, T_MIN, T_MAX, bounds=tbounds.cuda())
    want = ttri.closest_hit_blocks_plain(*targs, T_MIN, T_MAX)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[1][:, 0].tolist() == [256 + 3, 17] and bool((got[0] == 1.0).all())
    with pytest.raises(ValueError):  # the kernel needs the bounds
        ttri.closest_hit_blocks(*targs, T_MIN, T_MAX)


@pytest.mark.parametrize("order,bsub", [("window", 1), ("window", 2), ("key", 1), ("key", 2)])
def test_mesh_march_modes_match_plain(order, bsub):
    """K1 in segment mode (bounce 0: per-ray t_hi and carry-in on the pair
    stream) and in block mode (bounce 1: per-ray origins over the Morton
    table, block_sub 1 or 2), at the chip_smoke bars."""
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, order=order, bounce_order=order)
    record = _bounce_record(cfg)
    for rec, counter in ((record[0], "segment_launches"), (record[1], "block_launches"),
                         (record[2], "block_launches")):
        args, kw = rec["k1"]
        if "blocks" in kw and bsub > 1:  # the same listed blocks, two per chunk
            args = (*args[:4], args[4] * bsub)
            kw = {**kw, "block_sub": bsub}
        before = getattr(tmarch.march, counter)
        got = tmarch.march(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(tmarch.march, counter) == before + 1
        want = tmarch.march_plain(*args, **kw)
        for a, b in zip(got, want):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


def test_mesh_render_kernels_match_plain():
    """Glass sphere and mirror plane frames: kernel path vs plain path at
    >= 60 dB, equal block_dropped, and K4 / K1 block mode launched."""
    from gaussian_ray_tracing_tpu_torch.config import MeshType
    from gaussian_ray_tracing_tpu_torch.ops import tri as ttri
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_plane

    scene, cam, sphere = _mesh_case(size=192)
    plane = make_plane((0.0, 0.0, 0.5), device="cuda").with_type(MeshType.MIRROR)
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128)
    for mesh in (sphere, plane):
        k4, blk = ttri.closest_hit_blocks.launches, tmarch.march.block_launches
        gpu = render(scene, cam, cfg, mesh=mesh, method="gpu", return_aux=True)
        torch.cuda.synchronize()
        if mesh is sphere:
            assert ttri.closest_hit_blocks.launches > k4 and tmarch.march.block_launches > blk
        plain = render(scene, cam, cfg, mesh=mesh, method="plain", return_aux=True)
        assert gpu["aux"] == plain["aux"] and gpu["aux"]["pair_dropped"] == 0
        assert float(gpu["rgb"].max()) > 0.1
        assert psnr(gpu["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy()) >= 60.0


# --- SH 1-3, fisheye and OpenCV cameras, rolling shutter --------------------

def _camera(size=256, **kw):
    return Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=size, height=size,
                         device="cuda", **kw)


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("order", ["window", "key"])
@pytest.mark.parametrize("chunk", [128, 256])
def test_sh_march_kernel_matches_plain(degree, order, chunk):
    """K1's SH 1-3 mode on the quad SH rows of a 5k scene at 256^2."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = _camera()
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree)
    stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 18)
    assert feats.shape[1] == tmarch.quad_row(degree)
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], 16, 16)
    counter = "sh_key_launches" if order == "key" else "sh_launches"
    before = getattr(tmarch.march, counter)
    rgb, t_final = tmarch.march(stream.starts, feats, dirs_t, cfg, chunk)
    torch.cuda.synchronize()
    assert getattr(tmarch.march, counter) == before + 1
    rgb_p, t_p = tmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk)
    for a, b in ((rgb, rgb_p), (t_final, t_p)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


@pytest.mark.parametrize("model,degree,order", [("pinhole", 3, "window"), ("pinhole", 3, "key"),
                                                ("fisheye", 0, "window"), ("pinhole", 1, "window")])
def test_rolling_kernel_matches_plain(model, degree, order):
    """K1's per-ray-origin scalar mode on a rolling-shutter pair stream
    (the eye moves 0.05 in x during readout), then the whole frame."""
    from gaussian_ray_tracing_tpu_torch.config import CameraModel
    from gaussian_ray_tracing_tpu_torch.models.rolling import (
        prepare_rolling_stream, render_rolling,
    )

    scene = random_scene(5000, seed=3, device="cuda")
    cam0 = _camera()
    cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                         device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, order=order, sh_degree=degree,
                       camera_model=CameraModel(model))
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(scene, cam0, cam1, cfg)
    assert rows.shape[1] == tmarch.scalar_row(degree)
    before = tmarch.march.origin_launches
    got = tmarch.march(starts, rows, dirs_t, cfg, 128, origins_t=origins_t)
    torch.cuda.synchronize()
    assert tmarch.march.origin_launches == before + 1
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, 128, origins_t=origins_t)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    gpu = render_rolling(scene, cam0, cam1, cfg)["rgb"].cpu().numpy()
    plain = render_rolling(scene, cam0, cam1, cfg, use_kernels=False)["rgb"].cpu().numpy()
    assert gpu.max() > 0.1 and psnr(gpu, plain) >= 60.0


@pytest.mark.parametrize("sh", [0, 3])
def test_gpu_fisheye_and_opencv_frames(sh):
    """small_fisheye_256 through the kernel path >= 40 dB vs the exact
    oracle; fisheye and OpenCV frames at SH `sh` kernel vs plain >= 60 dB."""
    from gaussian_ray_tracing_tpu_torch.config import CameraModel

    z = np.load(os.path.join(ROOT, "data", "golden", "small_fisheye_256.npz"))
    n, seed, width, height, hm, fisheye = (int(v) for v in z["meta"])
    assert fisheye and width == height == 256
    scene = random_scene(n, seed=seed, device="cuda")
    fish = RenderConfig(hit_multiplicity=hm, march_chunk=128, camera_model=CameraModel.FISHEYE)
    if sh == 0:
        gpu = render(scene, _camera(), fish, method="gpu")["rgb"].cpu().numpy()
        assert psnr(gpu, z["rgb"].astype(np.float32)) >= 40.0
    opencv = fish.replace(camera_model=CameraModel.OPENCV, distortion=(-0.25, 0.05, 0.0, 0.0))
    for cfg in (fish.replace(sh_degree=sh), opencv.replace(sh_degree=sh)):
        gpu = render(scene, _camera(), cfg, method="gpu", return_aux=True)
        plain = render(scene, _camera(), cfg, method="plain", return_aux=True)
        assert gpu["aux"] == plain["aux"]
        assert psnr(gpu["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy()) >= 60.0


# --- merge order: K1's cross-chunk streaming merge; the exact oracle --------

def _merge_case(chunk, degree=0, hm=1, skip=0.02):
    scene = random_scene(5000, seed=3, device="cuda")
    cfg = RenderConfig(hit_multiplicity=hm, march_chunk=chunk, order="merge", sh_degree=degree,
                       chunk_skip_transmittance=skip)
    stream, feats, _ = prepare_pair_stream(scene, _camera(), cfg, 1 << 18)
    return cfg, (stream.starts, feats, tile_rays(generate_rays(_camera(), cfg)[1], 16, 16))


def _merge_check(args, kw, cfg, chunk, counters=("merge_launches",)):
    before = [getattr(tmarch.march, c) for c in counters]
    got = tmarch.march(*args, cfg, chunk, **kw)
    torch.cuda.synchronize()
    assert [getattr(tmarch.march, c) for c in counters] == [b + 1 for b in before]
    want = tmarch.march_plain(*args, cfg, chunk, **kw)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
@pytest.mark.parametrize("hm,skip", [(1, 0.02), (2, 1e-3)])
def test_merge_kernel_matches_plain(chunk, hm, skip):
    """K1 merge order on a 5k scene's 256^2 pair stream (quad, shared
    origin, full range) at the K1 bars."""
    cfg, args = _merge_case(chunk, hm=hm, skip=skip)
    _merge_check(args, {}, cfg, chunk)


def test_merge_sh3_kernel_matches_plain():
    cfg, args = _merge_case(128, degree=3)
    _merge_check(args, {}, cfg, 128)


@pytest.mark.parametrize("bsub", [1, 2])
def test_merge_mesh_modes_match_plain(bsub):
    """Merge order in segment mode (bounce 0, order="merge") and block mode
    (bounces 1-2, bounce_order="merge"), as in test_mesh_march_modes."""
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, order="merge", bounce_order="merge")
    record = _bounce_record(cfg)
    for rec, counter in ((record[0], "segment_launches"), (record[1], "merge_block_launches"),
                         (record[2], "merge_block_launches")):
        args, kw = rec["k1"]
        if "blocks" in kw and bsub > 1:
            args = (*args[:4], args[4] * bsub)
            kw = {**kw, "block_sub": bsub}
        _merge_check(args[:3], kw, args[3], args[4], ("merge_launches", counter))


def _merge_stream_check(counts, chunk, **kw):
    """K1 merge order on a hand-made depth_stream of 256-ray tiles against
    march_plain at the K1 bars (one launch counted), and two launches
    bit-identical. Returns the plain version's (chunks, slow chunks)."""
    starts, feats, dirs_t, _ = depth_stream(counts, rays=256, jitter=0.02, device="cuda", **kw)
    cfg = RenderConfig(hit_multiplicity=1, order="merge", march_chunk=chunk)
    _merge_check((starts, feats, dirs_t), {}, cfg, chunk)
    plain = (tmarch.march_plain.chunks, tmarch.march_plain.slow)
    a, b = (tmarch.march(starts, feats, dirs_t, cfg, chunk) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return plain


def _key_stream_check(counts, chunk, rays, **kw):
    """K1 key order on a hand-made depth_stream against march_plain at the
    K1 bars (one launch counted), and two launches bit-identical. Returns
    the plain version's marched chunks."""
    starts, feats, dirs_t, _ = depth_stream(counts, rays=rays, jitter=0.02, device="cuda", **kw)
    cfg = RenderConfig(hit_multiplicity=1, order="key", march_chunk=chunk)
    before = tmarch.march.launches
    got = tmarch.march(starts, feats, dirs_t, cfg, chunk)
    torch.cuda.synchronize()
    assert tmarch.march.launches == before + 1
    want = tmarch.march_plain(starts, feats, dirs_t, cfg, chunk)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    chunks = tmarch.march_plain.chunks
    again = tmarch.march(starts, feats, dirs_t, cfg, chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    return chunks


@pytest.mark.parametrize("rays", [256, 1024])
@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_key_order_sure_misses_and_short_tiles(chunk, rays):
    """Key order (the 256- and 1024-ray builds) on tiles without pairs,
    shorter than the chunk, with a ragged last chunk, with a chunk of sure
    misses (opacity below alpha_min), all sure misses, and every other
    candidate a sure miss."""
    counts = [0, chunk // 2, 3 * chunk + 5, 2 * chunk, 2 * chunk]
    faint = [(2, chunk, 2 * chunk), (3, 0, 2 * chunk)] + [(4, k, k + 1)
                                                        for k in range(0, 2 * chunk, 2)]
    chunks = _key_stream_check(counts, chunk, rays, faint=faint, op=0.05)
    assert chunks == 1 + 4 + 2 + 2


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_key_order_skips_chunks(chunk):
    """Nearly opaque candidates: every ray's T falls below the skip
    threshold within the first chunks, and the rest are skipped (with the
    next chunk's copy already in flight where two buffers fit)."""
    chunks = _key_stream_check([6 * chunk, 5 * chunk + 3], chunk, 256, op=0.9, spacing=0.01)
    assert 2 <= chunks < 12


@pytest.mark.parametrize("shape", [(1, 1), (1, 4095), (1, 4097), (1, 8191), (1, 8192), (1, 8193),
                                   (2, 4 * 8192 + 3), (3, 5), (16, 1_000_003), (2, 2_097_152)])
def test_scan_kernel_tile_edges_called_twice(shape):
    """K2 at the edges of its 8,192-element tiles (one element, half a tile
    either side, a tile less one, one tile, a tile and one, several tiles
    and 3), on rows that start
    off 16-byte alignment (P odd), at 16 channels and the headline's pair
    capacity, with wrapping sums; each shape twice in a row (the status
    words of the first call must not leak into the second), exact."""
    g = torch.Generator(device="cuda").manual_seed(shape[1])
    x = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device="cuda", generator=g)
    x[:, ::97] = 2**31 - 1
    want = tscan.multi_cumsum_i32_plain(x)
    for _ in range(2):
        assert torch.equal(tscan.multi_cumsum_i32(x), want)


def test_scan_kernel_on_a_misaligned_view():
    """A contiguous (2, P) view that starts 4 bytes into its storage: no row
    is 16-byte aligned, so every group takes 4-byte loads and stores."""
    g = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randint(-2**31, 2**31 - 1, (2 * 40_000 + 1,), dtype=torch.int32, device="cuda",
                        generator=g)
    x = buf[1:].view(2, 40_000)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert torch.equal(tscan.multi_cumsum_i32(x), tscan.multi_cumsum_i32_plain(x))


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_merge_tiles_without_pairs(chunk):
    """Tiles with no pairs between marched ones: their pending buffer is
    never written and composites nothing (rgb 0, T 1)."""
    chunks, _ = _merge_stream_check([0, 2 * chunk, 0, 0, chunk // 2, 0], chunk)
    assert chunks == 3


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_merge_ragged_last_chunk(chunk):
    """n not a multiple of C: the last chunk's tail slots (past the
    segment) take part in the merge as insignificant keys."""
    counts = [3 * chunk + 5, chunk + 1, 7]
    chunks, _ = _merge_stream_check(counts, chunk)
    assert chunks == 4 + 2 + 1


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_merge_chunk_without_significant_candidate(chunk):
    """A chunk whose every candidate is below alpha_min, after a fast chunk
    (tile 0) and after a slow one (tile 1): it becomes a pending buffer
    with no significant slot."""
    faint = [(0, chunk, 2 * chunk), (1, chunk, 2 * chunk)]
    chunks, slow = _merge_stream_check([3 * chunk, 3 * chunk], chunk, faint=faint,
                                       swaps=[(1, 0)])
    assert chunks == 6 and slow == 1


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_merge_every_chunk_slow(chunk):
    """An inversion planted at the start of every chunk, close enough (and
    faint enough) that the rays near the axis see all four: every marched
    chunk of the tile takes the slow walk."""
    chunks, slow = _merge_stream_check([4 * chunk], chunk, op=0.011, spacing=0.01,
                                       swaps=[(0, j * chunk) for j in range(4)])
    assert chunks == 4 and slow == 4


@pytest.mark.parametrize("name", ["small_pinhole_256", "small_hm2_256", "small_fisheye_256"])
def test_oracle_and_merge_render_match_goldens(name):
    """The goldens are float16 frames of the exact oracle: the torch oracle
    on the card >= 60 dB; the merge render (c=64) >= 40 dB and kernel vs
    plain >= 60 dB."""
    from gaussian_ray_tracing_tpu_torch.config import CameraModel

    z = np.load(os.path.join(ROOT, "data", "golden", f"{name}.npz"))
    n, seed, width, height, hm, fisheye = (int(v) for v in z["meta"])
    scene = random_scene(n, seed=seed, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=width,
                        height=height, device="cuda")
    cfg = RenderConfig(hit_multiplicity=hm, march_chunk=64, order="merge",
                       camera_model=CameraModel.FISHEYE if fisheye else CameraModel.PINHOLE)
    ref = z["rgb"].astype(np.float32)
    with torch.no_grad():
        oracle = render(scene, cam, cfg, method="oracle")["rgb"].cpu().numpy()
    assert psnr(oracle, ref) >= 60.0
    before = tmarch.march.merge_launches
    gpu = render(scene, cam, cfg, method="gpu")["rgb"].cpu().numpy()
    assert tmarch.march.merge_launches == before + 1
    plain = render(scene, cam, cfg, method="plain")["rgb"].cpu().numpy()
    assert psnr(gpu, ref) >= 40.0 and psnr(gpu, plain) >= 60.0


# --- the redesigned K1 window order and K3: edge cases of their new paths ---

def _fwd_bwd_check(cfg, starts, rows, dirs_t, eye, chunk):
    """K1 with saved carries (window: the scalar response from the eye) and
    K3 against their plain versions at the K1 bars and K3's per-column bars
    (1e-3, 2e-3 on the 9 M columns, the float64 witness at 1.25x), K3's two
    launches bit-identical."""
    kw = {"origins_t": eye.expand(dirs_t.shape).contiguous()} if cfg.order == "window" else {}
    got = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True, **kw)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, chunk, save_tin=True, **kw)
    for a, b in zip(got[:2], want[:2]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    g = torch.Generator(device="cuda").manual_seed(1)
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
    args = (starts, rows, dirs_t, eye, got[2], got[3], d_rgb, d_t, cfg, chunk)
    a, b = tbwd.march_bwd(*args), tbwd.march_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = tbwd.march_bwd_plain(*args)
    witness = tbwd.march_bwd_plain(*(x.double() if torch.is_tensor(x) and x.is_floating_point()
                                     else x for x in args))
    diff = tmarch.diff_columns(cfg.sh_degree)
    for i, c in enumerate(tmarch.train_columns(cfg.sh_degree)):
        if c not in diff:
            assert not a[:, i].any(), i
            continue
        bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
        assert float((a[:, i] - plain[:, i]).abs().max() / plain[:, i].abs().max()) <= bar, i
        k64, p64 = ((x[:, i] - witness[:, i]).abs().max() for x in (a, plain))
        assert float(k64) <= 1.25 * float(p64), i


def _render_check(starts, feats, dirs_t, cfg, chunk):
    got = tmarch.march(starts, feats, dirs_t, cfg, chunk)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, feats, dirs_t, cfg, chunk)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_ragged_last_chunk(chunk):
    """Tiles whose last chunk holds m < C candidates (the staging copies m
    rows, the passes see m) in K1's window render and window training
    forward and in K3's window and key replay."""
    for order in ("window", "key"):
        cfg, starts, rows, dirs_t, eye = _train_stream(chunk, order)
        counts = (starts[1:] - starts[:-1]).long()
        assert bool(((counts % chunk) != 0).any() & (counts > chunk).any())
        _fwd_bwd_check(cfg, starts, rows, dirs_t, eye, chunk)
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256,
                        height=256, device="cuda")
    rcfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, chunk_skip_transmittance=1e-3)
    stream, feats, _ = prepare_pair_stream(scene, cam, rcfg, 1 << 18)
    _render_check(stream.starts, feats, tile_rays(generate_rays(cam, rcfg)[1], 16, 16), rcfg,
                  chunk)


@pytest.mark.parametrize("order", ["window", "key"])
def test_warp_without_a_gated_lane(order):
    """Rays 32..63 of every tile are dead (zero direction), so that warp
    passes no gate anywhere: K3 skips it without evaluating and writes
    zero partials, K1's passes see no significant candidate there."""
    cfg, starts, rows, dirs_t, eye = _train_stream(128, order, 3 if order == "key" else 0)
    dirs_t = dirs_t.clone()
    dirs_t[:, 32:64] = 0.0
    _fwd_bwd_check(cfg, starts, rows, dirs_t, eye, 128)
    if order == "window":
        scene = random_scene(5000, seed=3, device="cuda")
        cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256,
                            height=256, device="cuda")
        rcfg = RenderConfig(hit_multiplicity=1, march_chunk=128)
        stream, feats, _ = prepare_pair_stream(scene, cam, rcfg, 1 << 18)
        d = tile_rays(generate_rays(cam, rcfg)[1], 16, 16).clone()
        d[:, 32:64] = 0.0
        _render_check(stream.starts, feats, d, rcfg, 128)


@pytest.mark.parametrize("order", ["window", "key"])
def test_backward_one_warp_tiles(order):
    """K3 (and K1's training forward) at R = 32: the first 32 rays of each
    tile of a 16x16-tiled stream, one warp per block (the cross-warp sum
    has one term)."""
    cfg, starts, rows, dirs_t, eye = _train_stream(128, order, 1)
    _fwd_bwd_check(cfg, starts, rows, dirs_t[:, :32].contiguous(), eye, 128)


@pytest.mark.parametrize("degree", [0, 3])
def test_window_march_1024_ray_tiles(degree):
    """K1 window order at R = 1024 (its 1024-ray build): each tile takes the
    rays and the candidate segments of four consecutive 16x16 tiles."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256,
                        height=256, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, sh_degree=degree)
    stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 18)
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], 16, 16)
    T = dirs_t.shape[0] // 4 * 4
    big = dirs_t[:T].reshape(T // 4, 1024, 3).contiguous()
    before = tmarch.march.launches
    _render_check(stream.starts[: T + 1 : 4].contiguous(), feats, big, cfg, 128)
    assert tmarch.march.launches == before + 1


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("order", ["window", "key"])
def test_backward_launches_bit_identical(order, degree):
    """Two K3 launches on the same inputs give the same bits: every sum of
    the transposed ray reduction and the cross-warp combine runs in a fixed
    order."""
    cfg, starts, rows, dirs_t, eye = _train_stream(128, order, degree)
    kw = {"origins_t": eye.expand(dirs_t.shape).contiguous()} if order == "window" else {}
    _, _, tin, base = tmarch.march(starts, rows, dirs_t, cfg, 128, save_tin=True, **kw)
    g = torch.Generator(device="cuda").manual_seed(2)
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
    args = (starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, 128)
    first = tbwd.march_bwd(*args)
    for _ in range(2):
        assert torch.equal(tbwd.march_bwd(*args), first)
    assert bool(first.any())


# --- mesh bounces at every camera model and SH degree; the viewer and CLI ---

def _kernel_close(got, want):
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


def _k4_bit_identical(args, kw):
    from gaussian_ray_tracing_tpu_torch.ops import tri as ttri

    stats = torch.zeros((args[3].shape[0], len(ttri.STATS)), dtype=torch.int32, device="cuda")
    got = ttri.closest_hit_blocks(*args, **kw, stats=stats)
    torch.cuda.synchronize()
    want = ttri.closest_hit_blocks_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))  # t, face, u, v bit for bit
    assert torch.equal(stats, ttri.pretest_stats(*args, kw["origins_t"], kw["bounds"]))


@pytest.mark.parametrize("model,degree", [("fisheye", 0), ("opencv", 0), ("pinhole", 3),
                                          ("fisheye", 3)])
def test_mesh_camera_kernels_match_plain(model, degree):
    """The glass sphere's frame under a fisheye or OpenCV camera and at SH 3:
    K4 bit-identical to its plain version on every bounce, K1's segment and
    block modes at the chip_smoke bars, the frame kernel vs plain >= 60 dB
    with equal aux and (fisheye) the corner black."""
    from gaussian_ray_tracing_tpu_torch.config import CameraModel
    from gaussian_ray_tracing_tpu_torch.models.mesh_tracer import render_with_mesh_fast

    scene, cam, mesh = _mesh_case()
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, sh_degree=degree,
                       camera_model=CameraModel(model),
                       distortion=(-0.25, 0.05, 0.0, 0.0) if model == "opencv" else ())
    record = []
    render_with_mesh_fast(scene, mesh, cam, cfg, record=record)
    assert len(record) >= 3 and "blocks" in record[1]["k1"][1]
    for rec in record:
        _k4_bit_identical(*rec["k4"])
        args, kw = rec["k1"]
        if "blocks" in kw:
            assert args[1].shape[1] == tmarch.scalar_row(degree)
        _kernel_close(tmarch.march(*args, **kw), tmarch.march_plain(*args, **kw))
    gpu = render(scene, cam, cfg, mesh=mesh, method="gpu", return_aux=True)
    plain = render(scene, cam, cfg, mesh=mesh, method="plain", return_aux=True)
    assert gpu["aux"] == plain["aux"] and gpu["aux"]["pair_dropped"] == 0
    assert psnr(gpu["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy()) >= 60.0
    if model == "fisheye":
        assert not gpu["rgb"][0, 0].any() and float(gpu["alpha"][0, 0]) == 0.0


@pytest.mark.parametrize("bsub", [1, 2])
@pytest.mark.parametrize("order", ["window", "key", "merge"])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_mesh_block_mode_sh_matches_plain(degree, order, bsub):
    """K1 block mode on the scalar SH 1-3 rows (the bounced rays of the
    glass sphere's frame), in every order at block_sub 1 and 2, and its
    segment mode on the quad SH rows of bounce 0."""
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, sh_degree=degree, order=order,
                       bounce_order=order)
    record = _bounce_record(cfg)
    for rec, counter in ((record[0], "segment_launches"), (record[1], "block_launches")):
        args, kw = rec["k1"]
        if "blocks" in kw and bsub > 1:
            args, kw = (*args[:4], args[4] * bsub), {**kw, "block_sub": bsub}
        before = getattr(tmarch.march, counter)
        got = tmarch.march(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(tmarch.march, counter) == before + 1
        _kernel_close(got, tmarch.march_plain(*args, **kw))


@pytest.mark.parametrize("model", ["fisheye", "opencv"])
def test_planar_mirror_cameras_match_plain(model):
    """The planar-mirror path under fisheye and OpenCV: both K1 segments at
    the chip_smoke bars, the frame kernel vs plain >= 60 dB."""
    from gaussian_ray_tracing_tpu_torch.config import CameraModel, MeshType
    from gaussian_ray_tracing_tpu_torch.models.mesh_tracer import render_with_mesh
    from gaussian_ray_tracing_tpu_torch.scene.mesh import make_plane

    scene, cam, _ = _mesh_case()
    plane = make_plane((0.0, 0.0, 1.6), device="cuda").with_type(MeshType.MIRROR)
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, camera_model=CameraModel(model),
                       distortion=(-0.25, 0.05, 0.0, 0.0) if model == "opencv" else ())
    record = []
    gpu = render_with_mesh(scene, plane, cam, cfg, record=record)
    assert len(record) == 2 and all(set(rec) == {"k1"} for rec in record)
    for rec in record:
        _kernel_close(tmarch.march(*rec["k1"][0], **rec["k1"][1]),
                      tmarch.march_plain(*rec["k1"][0], **rec["k1"][1]))
    plain = render_with_mesh(scene, plane, cam, cfg, use_kernels=False)
    assert gpu["aux"] == plain["aux"] and float(gpu["rgb"].max()) > 0.1
    assert psnr(gpu["rgb"].cpu().numpy(), plain["rgb"].cpu().numpy()) >= 60.0


def test_viewer_serves_kernel_frames():
    """viewer.serve on the card: a pinhole, a fisheye, a fisheye mirror and
    an SH 3 glass frame over HTTP, with K1, K2 and K4 launched."""
    import urllib.request

    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer
    from gaussian_ray_tracing_tpu_torch.ops import tri as ttri
    from gaussian_ray_tracing_tpu_torch.viewer import serve

    scene = random_scene(5000, seed=3, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128)
    servers = [serve(GaussianRayTracer(scene=scene, config=c), port=0, width=256, height=192,
                     block=False) for c in (cfg, cfg.replace(sh_degree=3))]
    counts = lambda: (tmarch.march.launches, tscan.multi_cumsum_i32.launches,
                      ttri.closest_hit_blocks.launches)
    try:
        get = lambda i, path: urllib.request.urlopen(
            f"http://127.0.0.1:{servers[i].server_address[1]}{path}", timeout=300).read()
        before = counts()
        frames = [get(0, "/frame?az=0&el=6&r=2.8"), get(0, "/frame?az=0&el=6&r=2.8&fisheye=1")]
        get(0, "/add?kind=plane")
        frames.append(get(0, "/frame?az=0&el=6&r=2.8&fisheye=1&type=mirror"))
        get(1, "/add?kind=sphere")
        frames.append(get(1, "/frame?az=0&el=6&r=2.8&type=glass"))
        after = counts()
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    assert all(f[:8] == b"\x89PNG\r\n\x1a\n" for f in frames)
    assert len(set(frames)) == 4
    assert all(a > b for a, b in zip(after, before))


def test_serving_cli_on_card(tmp_path, capsys):
    """cli orbit, warmup --assert and bench on the card."""
    import json

    from gaussian_ray_tracing_tpu_torch import cli

    small = ["--synthetic", "5000", "--width", "128", "--height", "96"]
    cli.main(["orbit", *small, "--frames", "2", "-o", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["frame_0000.png", "frame_0001.png"]
    cli.main(["warmup", *small, "--assert"])
    cli.main(["bench", *small, "--iters", "3"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines[3]["method"] == "gpu" and lines[4]["psnr_vs_golden"] >= 40.0
    bench = lines[-1]
    assert bench["backend"] == "cuda" and bench["timer"] == "cuda_events"
    assert bench["device"] == torch.cuda.get_device_name(0) and bench["mean_ms"] > 0


# --- the tiled march (models/tiled.py) as the reference of K1 and K3 -------
# tests/test_pallas.py's kernel-vs-tiled config and bars: K1 on the scalar
# response atol 2e-5, on the quad response >= 70 dB and max abs 1e-2; K3
# within 1e-3 of the largest entry of autograd's gradient per field
TILED_KEY = dict(hit_multiplicity=1, order="key", max_per_tile=4096,
                 chunk_skip_transmittance=1e-3)


@pytest.mark.parametrize("hm,sh", [(1, 0), (2, 0), (1, 3)])
def test_k1_matches_tiled_march(hm, sh):
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import render_gpu
    from gaussian_ray_tracing_tpu_torch.models.tiled import render_tiled
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan

    scene = random_scene(3000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64,
                        device="cuda")
    cfg = RenderConfig(**{**TILED_KEY, "hit_multiplicity": hm, "sh_degree": sh})
    k2 = kscan.multi_cumsum_i32.launches
    tiled = render_tiled(scene, cam, cfg, pair_capacity=200_000, return_aux=True)
    assert tiled["aux"]["n_dropped"] == 0 and kscan.multi_cumsum_i32.launches > k2
    before = tmarch.march.origin_launches
    scalar = render_gpu(scene, cam, cfg, pair_capacity=200_000, quad=False)
    assert tmarch.march.origin_launches == before + 1
    for k in ("rgb", "alpha"):
        a, b = scalar[k].cpu().numpy(), tiled[k].cpu().numpy()
        assert np.abs(a - b).max() <= 2e-5, k
    quad = render_gpu(scene, cam, cfg, pair_capacity=200_000)
    a, b = quad["rgb"].cpu().numpy(), tiled["rgb"].cpu().numpy()
    assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


@pytest.mark.parametrize("sh", [0, 3])
def test_k3_matches_tiled_autograd(sh):
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS

    scene = random_scene(500, seed=6)
    cam = Camera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64, height=32,
                        device="cuda")
    cfg = RenderConfig(**TILED_KEY, sh_degree=sh)
    grads = {}
    for method in ("gpu", "tiled"):
        model = GaussianModel.from_scene(scene.to("cuda")).requires_grad_(True)
        out = render_diff(model.activate(), cam, cfg, method=method, pair_capacity=100_000)
        torch.mean((out["rgb"] - 0.3) ** 2).backward()
        grads[method] = {f: getattr(model, f).grad.cpu().numpy() for f in FIELDS}
    for f in FIELDS:
        a, b = grads["gpu"][f], grads["tiled"][f]
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) < 1e-3, f


# --- per-ray origins: K1's per-ray-origin quad response, training with
# origins, windows and carry-in, K3's per-ray-origin backward --------------

def _rolling_train_stream(chunk, order="key", degree=0, seed=4):
    """A rolling-shutter stream of a 5k scene at 256^2 (the eye moves 0.05
    in x during readout) on the training rows, with per-ray windows and a
    carry-in drawn as tests/test_pallas.py:364-368 draws them."""
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream

    scene = random_scene(5000, seed=3, device="cuda")
    cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                         device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree)
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(scene, _camera(), cam1, cfg,
                                                                   train=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = dirs_t.shape[:2]
    seg = dict(origins_t=origins_t,
               t_lo=0.05 + 0.05 * torch.rand(shape, generator=g, device="cuda"),
               t_hi=3.0 + torch.rand(shape, generator=g, device="cuda"),
               t0=0.6 + 0.4 * torch.rand(shape, generator=g, device="cuda"))
    return cfg, starts, rows.detach().contiguous(), dirs_t, seg


@pytest.mark.parametrize("degree", [0, 3])
@pytest.mark.parametrize("order", ["window", "key", "merge"])
def test_origin_quad_march_matches_plain(order, degree):
    """K1's per-ray-origin quad response on a rolling-shutter stream against
    march_plain, and against the scalar response of the same rays."""
    cfg, starts, rows, dirs_t, seg = _rolling_train_stream(128, order, degree)
    o = seg["origins_t"]
    before = tmarch.march.origin_quad_launches
    got = tmarch.march(starts, rows, dirs_t, cfg, 128, origins_t=o, quad=True)
    torch.cuda.synchronize()
    assert tmarch.march.origin_quad_launches == before + 1
    _kernel_close(got, tmarch.march_plain(starts, rows, dirs_t, cfg, 128, origins_t=o, quad=True))
    if order == "key":  # the scalar response of the same rays: other rounding, the same
        # order (window and merge order sort near-ties by quantized event t
        # either way, as the shared-origin quad and scalar responses do)
        _kernel_close(got, tmarch.march(starts, rows, dirs_t, cfg, 128, origins_t=o))
    assert float(got[1].min()) < 0.5


TRAIN_ORIGIN_MODES = [("key", 0, False), ("key", 0, True), ("window", 0, False),
                      ("key", 3, False), ("window", 3, False), ("key", 3, True)]


@pytest.mark.parametrize("order,degree,quad", TRAIN_ORIGIN_MODES)
def test_origin_training_march_matches_plain(order, degree, quad):
    """K1 with saved carries from per-ray origins, windows and a carry-in
    (the scalar or the per-ray-origin quad response) against march_plain:
    rgb and T at the quad-path bars, the carries to 1e-4."""
    cfg, starts, rows, dirs_t, seg = _rolling_train_stream(256 if order == "key" else 128,
                                                           order, degree)
    chunk = cfg.march_chunk
    counter = "origin_quad_save_tin_launches" if quad else (
        "key_scalar_save_tin_launches" if order == "key"
        else "sh_save_tin_launches" if degree else "window_save_tin_launches")
    before = getattr(tmarch.march, counter)
    got = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True, quad=quad, **seg)
    torch.cuda.synchronize()
    assert getattr(tmarch.march, counter) == before + 1
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, chunk, save_tin=True, quad=quad, **seg)
    _kernel_close(got[:2], want[:2])
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("order,degree", [("key", 0), ("window", 0), ("key", 3), ("window", 3)])
def test_origin_backward_matches_plain_and_is_deterministic(order, degree):
    """K3 from per-ray origins and windows against march_bwd_plain, per
    written column at 1e-3 (2e-3 on the 9 M columns), as close to the
    float64 witness as the plain version (1.25x), and bit-identical across
    two launches."""
    cfg, starts, rows, dirs_t, seg = _rolling_train_stream(128, order, degree)
    _, _, tin, base = tmarch.march(starts, rows, dirs_t, cfg, 128, save_tin=True, **seg)
    g = torch.Generator(device="cuda").manual_seed(1)
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
    eye = torch.zeros(3, device="cuda")  # unused with per-ray origins
    args = (starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, 128)
    kw = {k: seg[k] for k in ("origins_t", "t_lo", "t_hi")}
    before = tbwd.march_bwd.origin_launches
    a, b = tbwd.march_bwd(*args, **kw), tbwd.march_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert tbwd.march_bwd.origin_launches == before + 2
    assert torch.equal(a, b)
    want = tbwd.march_bwd_plain(*args, **kw)
    f64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x
    witness = tbwd.march_bwd_plain(*map(f64, args), **{k: f64(v) for k, v in kw.items()})
    diff = tmarch.diff_columns(degree)
    for i, c in enumerate(tmarch.train_columns(degree)):
        if c not in diff:
            assert not a[:, i].any(), i
            continue
        bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
        assert float((a[:, i] - want[:, i]).abs().max() / want[:, i].abs().max()) <= bar, i
        k64, p64 = ((x[:, i] - witness[:, i]).abs().max() for x in (a, want))
        assert float(k64) <= 1.25 * float(p64), i


def test_march_stream_diff_with_origins_on_card():
    """march_stream_diff with quad, origins, windows and a carry-in: the
    kernels' gradient of the training rows against the plain versions'."""
    cfg, starts, rows, dirs_t, seg = _rolling_train_stream(256)
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(dirs_t.shape, generator=g, device="cuda")
    grads = []
    for use_kernels in (True, False):
        r = rows.clone().requires_grad_(True)
        rgb, _ = tbwd.march_stream_diff(r, starts, dirs_t, torch.zeros(3, device="cuda"), cfg,
                                        256, use_kernels, quad=True, **seg)
        torch.sum(rgb * w).backward()
        grads.append(r.grad)
    diff = tmarch.diff_columns(0)
    for i, c in enumerate(tmarch.TRAIN_COLUMNS):
        if c in diff:
            bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
            a, b = grads[0][:, i], grads[1][:, i]
            assert float((a - b).abs().max() / b.abs().max()) <= bar, i


# SHA-256 of (tin, chunk_base, d_rows) of K1's saved carries and K3 from
# the shared eye (key order; window order from per-ray origins each the
# eye), chunk 128, on _train_stream(128, order, degree): the kernels of
# commit 27fee07, before per-ray origins were added, measured on an NVIDIA
# H100 80GB HBM3 (700.00 W) by _shared_origin_digests with that commit's
# csrc loaded, cuda_build._lib = cuda_build.declare(ctypes.CDLL(str(
# cuda_build.build(<its csrc>, <a build dir>))), info=False)
DIGESTS_BEFORE = {
    "key sh0": "01c282a72695a67e5d4a3148f516c871b4c049f2a4de311e1eeea4a4db74dc92",
    "key sh1": "3a8f6f625232a4dcbd93fab991db66d3665d7cbd4b1785b4d505f3503bd79e92",
    "key sh2": "a8d50c45601e0e14e0bc9247d3df8568eb6a88c0c0fdbf339681e7bedf84a036",
    "key sh3": "0c5bcb35859eebacd8ee5d7abdbca0b804f1c85b30b373f714048e56b89cfe53",
    "window sh0": "ea7df86c3500457cc118a9ec55c0b3f96c970e3ce58919af30d5fb583a38c44e",
    "window sh1": "e853651b611be551b69f3d2c590a3a0b598f3bc592445189ab66f12f13411870",
    "window sh2": "6e3f3af53f8c4df48d1d82161728fa6690e71b03859f468e362e3c94f6d6a97b",
    "window sh3": "b3d08365b1fd8e61ebb3bc5a3e822bf2b364170dc4500cd6c51a28a113cff48e",
}


def _shared_origin_digests() -> dict:
    import hashlib

    out = {}
    for order in ("key", "window"):
        for degree in range(4):
            cfg, starts, rows, dirs_t, eye = _train_stream(128, order, degree)
            kw = {"origins_t": eye.expand(dirs_t.shape).contiguous()} if order == "window" else {}
            _, _, tin, base = tmarch.march(starts, rows, dirs_t, cfg, 128, save_tin=True, **kw)
            g = torch.Generator(device="cuda").manual_seed(2)
            d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
            d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
            d_rows = tbwd.march_bwd(starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, 128)
            h = hashlib.sha256()
            for x in (tin, base, d_rows):
                h.update(x.contiguous().cpu().numpy().tobytes())
            out[f"{order} sh{degree}"] = h.hexdigest()
    return out


def test_shared_origin_backward_unchanged():
    """K1's saved carries and K3 from the shared eye give the bits they
    gave before per-ray origins were added (DIGESTS_BEFORE)."""
    assert _shared_origin_digests() == DIGESTS_BEFORE


# --- tiles of 512 and 1024 rays: K1's saved carries and K3 --------------------

def _wide_train_stream(chunk, order, degree, tile_h):
    """The 5k scene's training stream at 256^2 on 32 x tile_h tiles."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = _camera()
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree,
                       tile_w=32, tile_h=tile_h)
    stream, rows, _ = prepare_train_stream(scene, cam, cfg)
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], 32, tile_h)
    assert dirs_t.shape[1] == 32 * tile_h
    return cfg, stream.starts, rows.detach().contiguous(), dirs_t, cam.eye


@pytest.mark.parametrize("order,degree,chunk,tile_h", [
    ("key", 0, 256, 32), ("window", 0, 128, 32), ("key", 3, 128, 32), ("window", 3, 64, 32),
    ("key", 0, 256, 16), ("window", 0, 128, 16)])
def test_wide_tile_training_kernels_match_plain(order, degree, chunk, tile_h):
    """K1 with saved carries and K3 on 1024- and 512-ray tiles (their
    1024-ray builds) against the plain versions at the K1 and K3 bars, two
    K3 launches bit-identical."""
    cfg, starts, rows, dirs_t, eye = _wide_train_stream(chunk, order, degree, tile_h)
    before = (tmarch.march.launches, tbwd.march_bwd.launches)
    _fwd_bwd_check(cfg, starts, rows, dirs_t, eye, chunk)
    assert (tmarch.march.launches, tbwd.march_bwd.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("order", ["window", "key", "merge"])
def test_wide_tile_origin_quad_render_matches_plain(order):
    """K1's per-ray-origin quad response on 1024-ray tiles of a rolling
    stream (the centroid's halving tree over 1024 origins) against
    march_plain."""
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream

    cfg = RenderConfig(hit_multiplicity=1, march_chunk=32, order=order, tile_w=32, tile_h=32)
    cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                         device="cuda")
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(
        random_scene(5000, seed=3, device="cuda"), _camera(), cam1, cfg, train=True)
    rows = rows.detach().contiguous()
    before = tmarch.march.origin_quad_launches
    got = tmarch.march(starts, rows, dirs_t, cfg, 32, origins_t=origins_t, quad=True)
    torch.cuda.synchronize()
    assert tmarch.march.origin_quad_launches == before + 1
    _kernel_close(got, tmarch.march_plain(starts, rows, dirs_t, cfg, 32, origins_t=origins_t,
                                          quad=True))
    assert float(got[1].min()) < 0.5


@pytest.mark.parametrize("quad", [False, True])
def test_wide_tile_origin_training_matches_plain(quad):
    """K1's saved carries from per-ray origins, windows and carry-in (key
    order, scalar or per-ray-origin quad response) and K3 from per-ray
    origins on 1024-ray tiles against the plain versions; two K3 launches
    bit-identical."""
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream

    cfg = RenderConfig(hit_multiplicity=1, march_chunk=256, order="key", tile_w=32, tile_h=32)
    cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                         device="cuda")
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(
        random_scene(5000, seed=3, device="cuda"), _camera(), cam1, cfg, train=True)
    rows = rows.detach().contiguous()
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = dirs_t.shape[:2]
    seg = dict(origins_t=origins_t,
               t_lo=0.05 + 0.05 * torch.rand(shape, generator=g, device="cuda"),
               t_hi=3.0 + torch.rand(shape, generator=g, device="cuda"),
               t0=0.6 + 0.4 * torch.rand(shape, generator=g, device="cuda"))
    got = tmarch.march(starts, rows, dirs_t, cfg, 256, save_tin=True, quad=quad, **seg)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, 256, save_tin=True, quad=quad, **seg)
    _kernel_close(got[:2], want[:2])
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(shape, generator=g, device="cuda")
    args = (starts, rows, dirs_t, torch.zeros(3, device="cuda"), got[2], got[3], d_rgb, d_t,
            cfg, 256)
    kw = {k: seg[k] for k in ("origins_t", "t_lo", "t_hi")}
    a, b = tbwd.march_bwd(*args, **kw), tbwd.march_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = tbwd.march_bwd_plain(*args, **kw)
    for i, c in enumerate(tmarch.train_columns(0)):
        if c in tmarch.diff_columns(0):
            bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
            assert float((a[:, i] - plain[:, i]).abs().max() / plain[:, i].abs().max()) <= bar, i


def test_scan_kernel_at_the_culled_binnings_channel_counts():
    """K2 at the head fill's channel counts with the pair culls (2-3
    context channels, + 6 conic and 2 span channels on pinhole, + 5 sector
    channels on fisheye) equals torch.cumsum."""
    g = torch.Generator(device="cuda").manual_seed(5)
    for shape in ((7, 1_300_001), (8, 1_300_001), (10, 1_300_001), (11, 1_300_001)):
        x = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device="cuda",
                          generator=g)
        assert torch.equal(tscan.multi_cumsum_i32(x), torch.cumsum(x, dim=1).to(torch.int32))


# --- K1's window-order render options and the peak key; K3's peak replay ---

OPTIONS = [
    ("window", dict(composite_scan=True), 16), ("key", dict(composite_scan=True), 16),
    ("merge", dict(composite_scan=True), 16), ("window", dict(sort_lane_groups=True), 16),
    ("window", dict(sort_lane_groups=True), 32), ("window", dict(sort_alpha_min=0.05), 16),
    ("window", dict(sort_alpha_min=0.4), 16),
    ("window", dict(sort_alpha_min=0.05, sort_repair=0), 16),
    ("window", dict(sort_alpha_min=0.05, sort_lane_groups=True), 32),
    ("window", dict(window_key="peak"), 16), ("merge", dict(window_key="peak"), 16),
    ("window", dict(window_key="peak"), 32),
]


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("order,kw,tile", OPTIONS)
def test_window_options_kernel_matches_plain(order, kw, tile, chunk):
    """K1 in each option against march_plain at the K1 bars, its per-tile
    fired and repaired chunk counts equal to the plain version's, and the
    option's launch counter moved."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                        device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, tile_w=tile,
                       tile_h=tile, **kw)
    stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 18)
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], tile, tile)
    counters = ("launches", "scan_launches", "group_launches", "fire_alpha_launches",
                "peak_launches")
    before = {c: getattr(tmarch.march, c) for c in counters}
    got = tmarch.march(stream.starts, feats, dirs_t, cfg, chunk, stats=True)
    torch.cuda.synchronize()
    moved = {c for c in counters if getattr(tmarch.march, c) != before[c]}
    assert "launches" in moved and len(moved) >= 2, moved
    want = tmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk, stats=True)
    _kernel_close(got[:2], want[:2])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)
    if order == "window":
        assert int(got[2][0].sum()) > 0


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("degree", [0, 3])
def test_peak_training_kernels_match_plain(degree, chunk):
    """Under window_key "peak": K1's window saved carries and K3's replay
    against their plain versions (carries 1e-4; per written column 1e-3, M
    2e-3, within 1.25x of the plain version's distance from float64), K3
    bit-identical over two launches, and the carries other than the event
    key's."""
    cfg, starts, rows, dirs_t, eye = _train_stream(chunk, "window", degree)
    cfg = cfg.replace(window_key="peak")
    kw = {"origins_t": eye.expand(dirs_t.shape).contiguous()}
    got = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True, **kw)
    event = tmarch.march(starts, rows, dirs_t, cfg.replace(window_key="event"), chunk,
                         save_tin=True, **kw)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, chunk, save_tin=True, **kw)
    _kernel_close(got[:2], want[:2])
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    assert not torch.equal(got[2], event[2])
    g = torch.Generator(device="cuda").manual_seed(1)
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
    args = (starts, rows, dirs_t, eye, got[2], got[3], d_rgb, d_t, cfg, chunk)
    before = tbwd.march_bwd.peak_launches
    a, b = tbwd.march_bwd(*args), tbwd.march_bwd(*args)
    torch.cuda.synchronize()
    assert tbwd.march_bwd.peak_launches == before + 2 and torch.equal(a, b)
    want = tbwd.march_bwd_plain(*args)
    witness = tbwd.march_bwd_plain(*(x.double() if torch.is_tensor(x) and x.is_floating_point()
                                     else x for x in args))
    for i, c in enumerate(tmarch.train_columns(degree)):
        if c not in tmarch.diff_columns(degree):
            assert not a[:, i].any(), i
            continue
        bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
        assert float((a[:, i] - want[:, i]).abs().max() / want[:, i].abs().max()) <= bar, i
        k64, p64 = ((x[:, i] - witness[:, i]).abs().max() for x in (a, want))
        assert float(k64) <= 1.25 * float(p64), i


@pytest.mark.parametrize("order", ["window", "key", "merge"])
@pytest.mark.parametrize("keys", ["tile", "tile_peak", "affine"])
def test_pair_key_march_matches_plain(keys, order):
    """K1 on a per-pair-key stream against march_plain at the K1 bars; the
    stream holds the default's pairs (the same starts and per-tile gaussian
    sets) in its own order; the affine binning's head fills are one K2
    launch, bit for bit the plain scan's binning."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                        device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, order=order, pair_keys=keys)
    before = tscan.multi_cumsum_i32.launches
    stream, feats, n_pairs = prepare_pair_stream(scene, cam, cfg, 1 << 18)
    assert tscan.multi_cumsum_i32.launches == before + (keys == "affine")
    plain_bin = prepare_pair_stream(scene, cam, cfg, 1 << 18, use_kernels=False)[0]
    assert all(torch.equal(a, b) for a, b in zip(stream[:5], plain_bin[:5]))
    base, _, base_pairs = prepare_pair_stream(scene, cam, cfg.replace(pair_keys="gaussian"),
                                              1 << 18)
    assert stream.order is None and n_pairs == base_pairs and torch.equal(stream.starts,
                                                                          base.starts)
    tile = torch.repeat_interleave(torch.arange(base.starts.numel() - 1, device="cuda"),
                                   (base.starts[1:] - base.starts[:-1]).long())
    codes = lambda ids: torch.sort(tile * scene.num_gaussians + ids.long()).values
    assert torch.equal(codes(stream.gid[:n_pairs]), codes(base.order[base.gid[:n_pairs].long()]))
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], 16, 16)
    before = tmarch.march.launches
    got = tmarch.march(stream.starts, feats, dirs_t, cfg, 128)
    torch.cuda.synchronize()
    assert tmarch.march.launches == before + 1
    _kernel_close(got, tmarch.march_plain(stream.starts, feats, dirs_t, cfg, 128))


@pytest.mark.parametrize("chunk", [64, 256])
def test_oddeven_march_matches_plain(chunk):
    """order="oddeven": K1's key kernel on the exact event gate against
    march_plain, equal to key order over [t_min, t_max] windows bit for
    bit (key order's exact gate), and the saved carries (the training
    forward on the scalar response) against the plain version."""
    scene = random_scene(5000, seed=3, device="cuda")
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                        device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order="oddeven")
    stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 18)
    dirs_t = tile_rays(generate_rays(cam, cfg)[1], 16, 16)
    before = tmarch.march.oddeven_launches
    got = tmarch.march(stream.starts, feats, dirs_t, cfg, chunk)
    torch.cuda.synchronize()
    assert tmarch.march.oddeven_launches == before + 1
    _kernel_close(got, tmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk))
    lo, hi = (torch.full(dirs_t.shape[:2], v, device="cuda") for v in (cfg.t_min, cfg.t_max))
    key = tmarch.march(stream.starts, feats, dirs_t, cfg.replace(order="key"), chunk, t_lo=lo,
                       t_hi=hi)
    assert torch.equal(got[0], key[0]) and torch.equal(got[1], key[1])
    tcfg, starts, rows, tdirs, eye = _train_stream(chunk, "key", 0)
    tcfg = tcfg.replace(order="oddeven")
    kw = {"origins_t": eye.expand(tdirs.shape).contiguous()}
    got = tmarch.march(starts, rows, tdirs, tcfg, chunk, save_tin=True, **kw)
    want = tmarch.march_plain(starts, rows, tdirs, tcfg, chunk, save_tin=True, **kw)
    _kernel_close(got[:2], want[:2])
    assert float((got[2] - want[2]).abs().max()) <= 1e-4


# --- tiles of 1152 to 8192 rays: K1 and K3 as clusters, K4 split ------------

WIDER = {1152: (48, 24), 2048: (64, 32), 4096: (64, 64), 8192: (128, 64)}


def _wider_stream(rays, order, chunk, degree=0, **kw):
    """The 5k scene's render stream at 256^2 on tiles of `rays` rays."""
    tw, th = WIDER[rays]
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree,
                       tile_w=tw, tile_h=th, **kw)
    scene = random_scene(5000, seed=3, device="cuda")
    stream, feats, _ = prepare_pair_stream(scene, _camera(), cfg, 1 << 19)
    dirs_t = tile_rays(generate_rays(_camera(), cfg)[1], tw, th)
    assert dirs_t.shape[1] == rays and int(stream.n_dropped) == 0
    return cfg, stream.starts, feats, dirs_t


@pytest.mark.parametrize("order,rays,chunk,degree", [
    ("window", 2048, 128, 0), ("window", 1152, 64, 0), ("window", 4096, 256, 3),
    ("window", 8192, 128, 0), ("key", 2048, 256, 0), ("key", 4096, 128, 3),
    ("merge", 2048, 128, 0), ("merge", 1152, 32, 0), ("oddeven", 4096, 64, 0)])
def test_cluster_march_matches_plain(order, rays, chunk, degree):
    """K1's cluster builds on tiles of 1152 to 8192 rays against march_plain
    at the K1 bars (window order: the per-tile fired chunks equal too), and
    two launches bit-identical."""
    cfg, starts, feats, dirs_t = _wider_stream(rays, order, chunk, degree)
    stats = order == "window"
    before = tmarch.march.launches
    got = tmarch.march(starts, feats, dirs_t, cfg, chunk, stats=stats)
    again = tmarch.march(starts, feats, dirs_t, cfg, chunk, stats=stats)
    torch.cuda.synchronize()
    assert tmarch.march.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got[:2], again[:2]))
    want = tmarch.march_plain(starts, feats, dirs_t, cfg, chunk, stats=stats)
    _kernel_close(got[:2], want[:2])
    assert float(got[1].min()) < 0.5
    if stats:
        for a, b in zip(got[2], want[2]):
            assert torch.equal(a, b)
        assert int(got[2][0].sum()) > 0


@pytest.mark.parametrize("rays", [1152, 2048])
@pytest.mark.parametrize("kw", [dict(sort_lane_groups=True),
                                dict(sort_alpha_min=0.05, sort_lane_groups=True),
                                dict(sort_alpha_min=0.05), dict(composite_scan=True)])
def test_cluster_window_options_match_plain(kw, rays):
    """The window-order options on cluster tiles: lane groups of 128 rays
    inside each block of the cluster (640 + 512 rays at R = 1152), the
    band's reduction across the cluster, and their counts equal to
    plain's."""
    cfg, starts, feats, dirs_t = _wider_stream(rays, "window", 128, **kw)
    before = tmarch.march.launches
    got = tmarch.march(starts, feats, dirs_t, cfg, 128, stats=True)
    torch.cuda.synchronize()
    assert tmarch.march.launches == before + 1
    want = tmarch.march_plain(starts, feats, dirs_t, cfg, 128, stats=True)
    _kernel_close(got[:2], want[:2])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("order,degree,chunk,rays", [
    ("key", 0, 256, 2048), ("window", 0, 128, 2048), ("key", 3, 128, 4096),
    ("window", 3, 64, 4096), ("key", 0, 64, 1152), ("window", 0, 32, 1152),
    ("key", 0, 256, 8192)])
def test_cluster_training_kernels_match_plain(order, degree, chunk, rays):
    """K1's saved carries and K3 as clusters against their plain versions
    at the K1 and K3 bars (the float64 witness at 1.25x), K3's two launches
    bit-identical (its sums over the tile's rays in a fixed rank order)."""
    tw, th = WIDER[rays]
    scene = random_scene(5000, seed=3, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree,
                       tile_w=tw, tile_h=th)
    stream, rows, _ = prepare_train_stream(scene, _camera(), cfg)
    dirs_t = tile_rays(generate_rays(_camera(), cfg)[1], tw, th)
    before = (tmarch.march.launches, tbwd.march_bwd.launches)
    _fwd_bwd_check(cfg, stream.starts, rows.detach().contiguous(), dirs_t, _camera().eye, chunk)
    assert (tmarch.march.launches, tbwd.march_bwd.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("order", ["window", "key", "merge"])
def test_cluster_origin_quad_render_matches_plain(order):
    """K1's per-ray-origin quad response on 2048-ray tiles of a rolling
    stream (the centroid's halving tree over the tile's 2048 origins, its
    first level across the cluster's two blocks) against march_plain."""
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream

    cfg = RenderConfig(hit_multiplicity=1, march_chunk=64, order=order, tile_w=64, tile_h=32)
    cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                         device="cuda")
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(
        random_scene(5000, seed=3, device="cuda"), _camera(), cam1, cfg, train=True)
    rows = rows.detach().contiguous()
    before = tmarch.march.origin_quad_launches
    got = tmarch.march(starts, rows, dirs_t, cfg, 64, origins_t=origins_t, quad=True)
    torch.cuda.synchronize()
    assert tmarch.march.origin_quad_launches == before + 1
    _kernel_close(got, tmarch.march_plain(starts, rows, dirs_t, cfg, 64, origins_t=origins_t,
                                          quad=True))


@pytest.mark.parametrize("quad", [False, True])
def test_cluster_origin_training_matches_plain(quad):
    """K1's saved carries from per-ray origins, windows and carry-in and K3
    from per-ray origins on 2048-ray tiles against the plain versions; two
    K3 launches bit-identical."""
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream

    cfg = RenderConfig(hit_multiplicity=1, march_chunk=256, order="key", tile_w=64, tile_h=32)
    cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                         device="cuda")
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(
        random_scene(5000, seed=3, device="cuda"), _camera(), cam1, cfg, train=True)
    rows = rows.detach().contiguous()
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = dirs_t.shape[:2]
    seg = dict(origins_t=origins_t,
               t_lo=0.05 + 0.05 * torch.rand(shape, generator=g, device="cuda"),
               t_hi=3.0 + torch.rand(shape, generator=g, device="cuda"),
               t0=0.6 + 0.4 * torch.rand(shape, generator=g, device="cuda"))
    got = tmarch.march(starts, rows, dirs_t, cfg, 256, save_tin=True, quad=quad, **seg)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, 256, save_tin=True, quad=quad, **seg)
    _kernel_close(got[:2], want[:2])
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(shape, generator=g, device="cuda")
    args = (starts, rows, dirs_t, torch.zeros(3, device="cuda"), got[2], got[3], d_rgb, d_t,
            cfg, 256)
    kw = {k: seg[k] for k in ("origins_t", "t_lo", "t_hi")}
    a, b = tbwd.march_bwd(*args, **kw), tbwd.march_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = tbwd.march_bwd_plain(*args, **kw)
    for i, c in enumerate(tmarch.train_columns(0)):
        if c in tmarch.diff_columns(0):
            bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
            assert float((a[:, i] - plain[:, i]).abs().max() / plain[:, i].abs().max()) <= bar, i


@pytest.mark.parametrize("order", ["window", "key", "merge"])
@pytest.mark.parametrize("rays", [2048, 1152])
def test_split_tile_mesh_kernels_match_plain(rays, order):
    """K4 split over the blocks of 1152- and 2048-ray tiles (bit for bit,
    its counts those of pretest_stats' slices) and K1's segment and block
    modes as clusters (the K1 bars), on every bounce of the glass-sphere
    frame."""
    tw, th = WIDER[rays]
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, order=order, bounce_order=order,
                       tile_w=tw, tile_h=th)
    record = _bounce_record(cfg)
    for rec in record:
        assert rec["k4"][0][3].shape[1] == rays
        _k4_bit_identical(*rec["k4"])
        args, kw = rec["k1"]
        _kernel_close(tmarch.march(*args, **kw), tmarch.march_plain(*args, **kw))


def test_cluster_launch_info():
    """What the cluster builds run: a cluster of ceil(R / 1024) blocks, at
    most 64 registers a thread, and at least one cluster resident."""
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build

    for rays, n in ((1152, 2), (2048, 2), (4096, 4), (8192, 8)):
        for kernel, kw in (("march", dict(order="window")), ("march", dict(order="merge")),
                           ("march", dict(order="key", train=True)),
                           ("march_bwd", dict(order="window")), ("march_bwd", dict(order="key"))):
            info = cuda_build.launch_info(kernel, 256 if kernel == "march" else 128, 3, rays,
                                          **kw)
            assert info["cluster_blocks"] == n and info["resident_clusters"] >= 1, (rays, info)
            assert info["registers"] <= 64


# --- key and oddeven order at any chunk: K1's key kernel and K3's key
# replay at a runtime chunk, staged on the smallest build that holds it
# (above 256, block mode's chunk * block_sub, in pieces) ------------------

@pytest.mark.parametrize("order,chunk", [("key", 96), ("key", 100), ("oddeven", 96),
                                         ("oddeven", 100), ("key", 40)])
def test_any_chunk_key_march_matches_plain(order, chunk):
    """K1's key kernel at a chunk that is not a power of two (on the 128- or
    64-candidate build) against march_plain at the K1 bars, two launches
    bit-identical, and the frame unlike chunk 128's (the chunk's skip and
    composite restart follow it)."""
    scene = random_scene(5000, seed=3, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order)
    stream, feats, _ = prepare_pair_stream(scene, _camera(), cfg, 1 << 18)
    dirs_t = tile_rays(generate_rays(_camera(), cfg)[1], 16, 16)
    counts = (stream.starts[1:] - stream.starts[:-1]).long()
    assert bool(((counts % chunk) != 0).any() & (counts > 2 * chunk).any())
    before = tmarch.march.launches
    got = tmarch.march(stream.starts, feats, dirs_t, cfg, chunk)
    again = tmarch.march(stream.starts, feats, dirs_t, cfg, chunk)
    torch.cuda.synchronize()
    assert tmarch.march.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _kernel_close(got, tmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk))
    at_128 = tmarch.march(stream.starts, feats, dirs_t, cfg, 128)
    assert float((at_128[0] - got[0]).abs().max()) > 1e-4


@pytest.mark.parametrize("rays", [256, 1024])
@pytest.mark.parametrize("chunk", [96, 100])
def test_any_chunk_key_order_sure_misses_and_short_tiles(chunk, rays):
    """test_key_order_sure_misses_and_short_tiles' hand-made tiles at a
    chunk that is not a power of two (a tile shorter than the chunk, a
    ragged last chunk, runs of sure misses), and nearly opaque tiles whose
    later chunks are skipped."""
    counts = [0, chunk // 2, 3 * chunk + 5, 2 * chunk, 2 * chunk]
    faint = [(2, chunk, 2 * chunk), (3, 0, 2 * chunk)] + [(4, k, k + 1)
                                                        for k in range(0, 2 * chunk, 2)]
    assert _key_stream_check(counts, chunk, rays, faint=faint, op=0.05) == 1 + 4 + 2 + 2
    chunks = _key_stream_check([6 * chunk, 5 * chunk + 3], chunk, 256, op=0.9, spacing=0.01)
    assert 2 <= chunks < 12


@pytest.mark.parametrize("chunk,degree", [(96, 0), (100, 0), (96, 3)])
def test_any_chunk_training_kernels_match_plain(chunk, degree):
    """K1's saved carries (chunk_base and one carry row per chunk of
    `chunk`) and K3's key replay (its mask of ceil(chunk / 32) words, the
    tail group of 16 cut to the chunk) against their plain versions at the
    K1 and K3 bars, K3's two launches bit-identical; oddeven at chunk 96
    trains the same kernels."""
    cfg, starts, rows, dirs_t, eye = _train_stream(chunk, "key", degree)
    counts = (starts[1:] - starts[:-1]).long()
    assert bool(((counts % chunk) != 0).any() & (counts > 2 * chunk).any())
    before = (tmarch.march.launches, tbwd.march_bwd.launches)
    _fwd_bwd_check(cfg, starts, rows, dirs_t, eye, chunk)
    assert (tmarch.march.launches, tbwd.march_bwd.launches) == (before[0] + 1, before[1] + 2)
    _, _, _, base = tmarch.march(starts, rows, dirs_t, cfg, chunk, save_tin=True)
    assert torch.equal(base[1:].long(), torch.cumsum((counts + chunk - 1) // chunk, 0))


@pytest.mark.parametrize("quad", [False, True])
def test_any_chunk_origin_training_matches_plain(quad):
    """Training from per-ray origins with windows and carry-in at chunk 96:
    K1's saved carries (scalar or per-ray-origin quad response) and K3's
    per-ray-origin key replay against their plain versions."""
    cfg, starts, rows, dirs_t, seg = _rolling_train_stream(96, "key", 0)
    got = tmarch.march(starts, rows, dirs_t, cfg, 96, save_tin=True, quad=quad, **seg)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, 96, save_tin=True, quad=quad, **seg)
    _kernel_close(got[:2], want[:2])
    assert float((got[2] - want[2]).abs().max()) <= 1e-4
    assert torch.equal(got[3], want[3])
    g = torch.Generator(device="cuda").manual_seed(1)
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(dirs_t.shape[:2], generator=g, device="cuda")
    args = (starts, rows, dirs_t, torch.zeros(3, device="cuda"), got[2], got[3], d_rgb, d_t,
            cfg, 96)
    kw = {k: seg[k] for k in ("origins_t", "t_lo", "t_hi")}
    a, b = tbwd.march_bwd(*args, **kw), tbwd.march_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = tbwd.march_bwd_plain(*args, **kw)
    for i, c in enumerate(tmarch.train_columns(0)):
        if c not in tmarch.diff_columns(0):
            assert not a[:, i].any(), i
            continue
        bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
        assert float((a[:, i] - plain[:, i]).abs().max() / plain[:, i].abs().max()) <= bar, i


@pytest.mark.parametrize("chunk,bsub,bounce_order", [
    pytest.param(256, 2, "key", id="256-2"), pytest.param(96, 3, "key", id="96-3"),
    pytest.param(128, 3, "key", id="128-3"), pytest.param(256, 2, "oddeven", id="256-2-oddeven")])
def test_any_chunk_key_block_mode_matches_plain(chunk, bsub, bounce_order):
    """K1's key-order block mode over chunk * bsub rows (512, 288 and 384:
    above 256, staged in pieces of 256 rows, one composite over the whole
    chunk) on the glass sphere's bounced rays, against march_plain, two
    launches bit-identical; under bounce_order "oddeven" too (the key
    kernel on the exact event gate, 512 rows)."""
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order="key",
                       bounce_order=bounce_order, bounce_blocks_per_chunk=bsub)
    record = _bounce_record(cfg)
    for rec in record[1:3]:
        args, kw = rec["k1"]
        assert args[4] == chunk * bsub and kw["block_sub"] == bsub
        assert args[3].order == bounce_order
        before = tmarch.march.block_launches, tmarch.march.oddeven_launches
        got = tmarch.march(*args, **kw)
        again = tmarch.march(*args, **kw)
        torch.cuda.synchronize()
        assert tmarch.march.block_launches == before[0] + 2
        assert tmarch.march.oddeven_launches == before[1] + 2 * (bounce_order == "oddeven")
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _kernel_close(got, tmarch.march_plain(*args, **kw))


def test_any_chunk_cluster_key_march_matches_plain():
    """K1's key kernel as a cluster (64x32 tiles, 2048 rays) at chunk 96,
    in key order and oddeven, against march_plain; its launch info at chunk
    96 is the 128-candidate build's."""
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build

    for order in ("key", "oddeven"):
        cfg, starts, feats, dirs_t = _wider_stream(2048, order, 96)
        before = tmarch.march.cluster_launches
        got = tmarch.march(starts, feats, dirs_t, cfg, 96)
        torch.cuda.synchronize()
        assert tmarch.march.cluster_launches == before + 1
        _kernel_close(got, tmarch.march_plain(starts, feats, dirs_t, cfg, 96))
        assert float(got[1].min()) < 0.5
    info = {c: cuda_build.launch_info("march", c, 0, 2048, order="key") for c in (96, 128)}
    assert info[96] == info[128] and info[96]["build_chunk"] == 128
    with pytest.raises(RuntimeError):  # window order takes only its four builds' chunks
        cuda_build.launch_info("march", 96, 0, 256, order="window")


# --- tiles of more than 8192 rays: K1 and K3 march several rays a thread in
# one cluster of 8 blocks, K4 splits over any number of blocks --------------

HUGE = {8320: (130, 64), 16384: (128, 128), 24576: (192, 128), 65536: (256, 256)}


def _huge_stream(rays, order, chunk, degree=0, size=256, **kw):
    """The 5k scene's render stream at size^2 on tiles of `rays` rays."""
    tw, th = HUGE[rays]
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree,
                       tile_w=tw, tile_h=th, **kw)
    scene = random_scene(5000, seed=3, device="cuda")
    stream, feats, _ = prepare_pair_stream(scene, _camera(size), cfg, 1 << 20)
    dirs_t = tile_rays(generate_rays(_camera(size), cfg)[1], tw, th)
    assert dirs_t.shape[1] == rays and int(stream.n_dropped) == 0
    return cfg, stream.starts, feats, dirs_t


@pytest.mark.parametrize("order,rays,chunk,degree", [
    ("window", 8320, 128, 0), ("window", 16384, 128, 0), ("window", 24576, 64, 3),
    ("window", 65536, 128, 0), ("key", 8320, 256, 0), ("key", 16384, 128, 0),
    ("key", 24576, 128, 3), ("key", 65536, 64, 0), ("merge", 8320, 128, 0),
    ("merge", 16384, 64, 0), ("merge", 65536, 32, 0), ("oddeven", 16384, 96, 0),
    ("oddeven", 24576, 128, 0)])
def test_huge_tile_march_matches_plain(order, rays, chunk, degree):
    """K1 with several rays a thread (ceil(R / 8192) slots) on tiles of 8320
    to 65,536 rays against march_plain at the K1 bars (window order: the
    per-tile fired chunks equal too), two launches bit-identical."""
    cfg, starts, feats, dirs_t = _huge_stream(rays, order, chunk, degree)
    stats = order == "window"
    before = (tmarch.march.launches, tmarch.march.slot_launches)
    got = tmarch.march(starts, feats, dirs_t, cfg, chunk, stats=stats)
    again = tmarch.march(starts, feats, dirs_t, cfg, chunk, stats=stats)
    torch.cuda.synchronize()
    assert (tmarch.march.launches, tmarch.march.slot_launches) == (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], again[:2]))
    want = tmarch.march_plain(starts, feats, dirs_t, cfg, chunk, stats=stats)
    _kernel_close(got[:2], want[:2])
    assert float(got[1].min()) < 0.5
    if stats:
        for a, b in zip(got[2], want[2]):
            assert torch.equal(a, b)
        assert int(got[2][0].sum()) > 0


@pytest.mark.parametrize("kw", [dict(sort_lane_groups=True),
                                dict(sort_alpha_min=0.05, sort_lane_groups=True),
                                dict(sort_alpha_min=0.05), dict(composite_scan=True)])
def test_huge_tile_window_options_match_plain(kw):
    """The window-order options at 16,384 rays: 128-ray fire groups in each
    block and slot, the band's reduction over the slots and the cluster,
    and their counts equal to plain's."""
    cfg, starts, feats, dirs_t = _huge_stream(16384, "window", 128, **kw)
    got = tmarch.march(starts, feats, dirs_t, cfg, 128, stats=True)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, feats, dirs_t, cfg, 128, stats=True)
    _kernel_close(got[:2], want[:2])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("order,degree,chunk,rays", [
    ("key", 0, 256, 8320), ("window", 0, 128, 8320), ("key", 0, 128, 16384),
    ("window", 0, 64, 16384), ("key", 3, 128, 24576), ("window", 3, 64, 24576),
    ("key", 0, 256, 65536), ("window", 0, 128, 65536)])
def test_huge_tile_training_kernels_match_plain(order, degree, chunk, rays):
    """K1's saved carries and K3 with several rays a thread against their
    plain versions at the K1 and K3 bars (the float64 witness at 1.25x),
    K3's two launches bit-identical (each block's slots in slot order, the
    blocks in rank order, in double)."""
    tw, th = HUGE[rays]
    scene = random_scene(5000, seed=3, device="cuda")
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree,
                       tile_w=tw, tile_h=th)
    stream, rows, _ = prepare_train_stream(scene, _camera(), cfg)
    dirs_t = tile_rays(generate_rays(_camera(), cfg)[1], tw, th)
    before = (tmarch.march.slot_launches, tbwd.march_bwd.slot_launches)
    _fwd_bwd_check(cfg, stream.starts, rows.detach().contiguous(), dirs_t, _camera().eye, chunk)
    assert (tmarch.march.slot_launches, tbwd.march_bwd.slot_launches) == (before[0] + 1,
                                                                         before[1] + 2)


@pytest.mark.parametrize("rays", [16384, 65536])
def test_huge_tile_origin_quad_matches_plain(rays):
    """The per-ray-origin quad response on a rolling stream at 16,384 and
    65,536 rays a tile (the centroid's halving tree summed as the origins
    are read down to 4096 values a coordinate, across the blocks and the
    slots): K1 in window, key and merge order, and K1's saved carries and
    K3 from per-ray origins, windows and carry-in, against the plain
    versions; two K3 launches bit-identical."""
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream

    tw, th = HUGE[rays]
    cam1 = Camera.create(eye=(0.05, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=256, height=256,
                         device="cuda")
    scene = random_scene(5000, seed=3, device="cuda")
    for order in ("window", "key", "merge"):
        cfg = RenderConfig(hit_multiplicity=1, march_chunk=64, order=order, tile_w=tw,
                           tile_h=th)
        starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(scene, _camera(), cam1,
                                                                       cfg, train=True)
        rows = rows.detach().contiguous()
        got = tmarch.march(starts, rows, dirs_t, cfg, 64, origins_t=origins_t, quad=True)
        torch.cuda.synchronize()
        _kernel_close(got, tmarch.march_plain(starts, rows, dirs_t, cfg, 64,
                                              origins_t=origins_t, quad=True))
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=256, order="key", tile_w=tw, tile_h=th)
    starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(scene, _camera(), cam1, cfg,
                                                                   train=True)
    rows = rows.detach().contiguous()
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = dirs_t.shape[:2]
    seg = dict(origins_t=origins_t,
               t_lo=0.05 + 0.05 * torch.rand(shape, generator=g, device="cuda"),
               t_hi=3.0 + torch.rand(shape, generator=g, device="cuda"),
               t0=0.6 + 0.4 * torch.rand(shape, generator=g, device="cuda"))
    got = tmarch.march(starts, rows, dirs_t, cfg, 256, save_tin=True, quad=True, **seg)
    torch.cuda.synchronize()
    want = tmarch.march_plain(starts, rows, dirs_t, cfg, 256, save_tin=True, quad=True, **seg)
    _kernel_close(got[:2], want[:2])
    # A ray whose carry lands within a few ulps of min_transmittance at a
    # crossing freezes a candidate apart in the two versions (the plain one
    # sums log1p(-a) by torch.cumsum's scan, K1 in sequence, so they part by
    # ulps) and its later carries differ: at 65,536 rays one ray of this
    # stream (plain 9.999996e-4 against 1e-3). Its column is held apart, and
    # there is at most one.
    tie = ((want[2] - cfg.min_transmittance).abs() <= 1e-9).any(0)
    assert int(tie.sum()) <= 1
    assert float((got[2] - want[2])[:, ~tie].abs().max()) <= 1e-4
    d_rgb = torch.randn(dirs_t.shape, generator=g, device="cuda")
    d_t = torch.randn(shape, generator=g, device="cuda")
    args = (starts, rows, dirs_t, torch.zeros(3, device="cuda"), got[2], got[3], d_rgb, d_t,
            cfg, 256)
    kw = {k: seg[k] for k in ("origins_t", "t_lo", "t_hi")}
    a, b = tbwd.march_bwd(*args, **kw), tbwd.march_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = tbwd.march_bwd_plain(*args, **kw)
    for i, c in enumerate(tmarch.train_columns(0)):
        if c in tmarch.diff_columns(0):
            bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
            assert float((a[:, i] - plain[:, i]).abs().max() / plain[:, i].abs().max()) <= bar, i


@pytest.mark.parametrize("order", ["window", "key", "merge"])
@pytest.mark.parametrize("rays", [16384, 8320])
def test_huge_tile_mesh_kernels_match_plain(rays, order):
    """K4 split over 9 or 16 blocks a tile (bit for bit, its counts those of
    pretest_stats' slices) and K1's segment and block modes with several
    rays a thread (the K1 bars), on every bounce of the glass-sphere
    frame."""
    tw, th = HUGE[rays]
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, order=order, bounce_order=order,
                       tile_w=tw, tile_h=th)
    record = _bounce_record(cfg)
    for rec in record:
        assert rec["k4"][0][3].shape[1] == rays
        _k4_bit_identical(*rec["k4"])
        args, kw = rec["k1"]
        _kernel_close(tmarch.march(*args, **kw), tmarch.march_plain(*args, **kw))


def test_single_tile_key_render_matches_plain():
    """One 512x512 tile (R = 262,144: 32 rays a thread) in key order, and
    its training forward and K3, against the plain versions."""
    cfg = RenderConfig(hit_multiplicity=1, march_chunk=128, order="key", tile_w=512,
                       tile_h=512)
    scene = random_scene(5000, seed=3, device="cuda")
    stream, feats, _ = prepare_pair_stream(scene, _camera(512), cfg, 1 << 18)
    dirs_t = tile_rays(generate_rays(_camera(512), cfg)[1], 512, 512)
    assert dirs_t.shape == (1, 262144, 3)
    got = tmarch.march(stream.starts, feats, dirs_t, cfg, 128)
    torch.cuda.synchronize()
    _kernel_close(got, tmarch.march_plain(stream.starts, feats, dirs_t, cfg, 128))
    assert float(got[1].min()) < 0.5
    stream, rows, _ = prepare_train_stream(scene, _camera(512), cfg)
    _fwd_bwd_check(cfg, stream.starts, rows.detach().contiguous(), dirs_t, _camera(512).eye, 128)


def test_huge_tile_launch_info():
    """What the cluster builds run above 8192 rays: 8 blocks of 1024
    threads, ceil(R / 8192) rays a thread, at most 64 registers, at least
    one cluster resident; the carry and scratch each ray needs."""
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build

    lib = cuda_build.load_library()
    for rays, k in ((8320, 2), (16384, 2), (24576, 3), (65536, 8), (262144, 32)):
        for kernel, kw in (("march", dict(order="window")), ("march", dict(order="merge")),
                           ("march", dict(order="key", train=True)),
                           ("march", dict(order="key", quad=True)),
                           ("march_bwd", dict(order="window")), ("march_bwd", dict(order="key"))):
            info = cuda_build.launch_info(kernel, 128, 0, rays, **kw)
            assert info["cluster_blocks"] == 8 and info["rays_per_thread"] == k, (rays, info)
            assert info["resident_clusters"] >= 1 and info["registers"] <= 64
        assert lib.grt_march_carry_floats(128, 2, rays) == 5 + 3 * 128 + 4
        assert lib.grt_march_bwd_scratch_bytes(128, 0, 1, rays, 3) == 3 * (8 * 128 * 32 * 8
                                                                          + rays * 4)
    assert cuda_build.launch_info("march", 128, 0, 8192, order="key")["rays_per_thread"] == 1
    assert lib.grt_march_carry_floats(128, 0, 8192) == 0
    assert lib.grt_march_bwd_scratch_bytes(128, 0, 1, 8192, 3) == 0


def test_huge_frame_scratch_runs_in_launches_that_fit():
    """A frame whose tiles' scratch, all at once, would not fit on the card:
    570 tiles of 65,536 rays in merge order at chunk 256 (781 carried floats
    a ray) run as launches of the tiles SCRATCH_BYTES holds, each reusing
    the scratch from its first tile. Every tile of rows gives the one-tile
    launch's output bit for bit, wherever it falls in its launch, every
    empty tile the empty tile's, and the one tile holds to march_plain at
    the K1 bars."""
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build

    cfg, starts, feats, dirs_t = _huge_stream(65536, "merge", 256)
    T, R = 570, dirs_t.shape[1]
    fields = cuda_build.load_library().grt_march_carry_floats(256, 2, R)
    assert fields == 781 and dirs_t.shape[0] == 1
    assert T * fields * R * 4 > torch.cuda.get_device_properties(0).total_memory
    held = tmarch.scratch_tiles(4 * fields * R, T)
    assert 1 < held < T and T % held != 0
    lo, hi = int(starts[0]), int(starts[1])
    full = torch.arange(T, device="cuda") % 9 == 0  # tiles of rows, in every launch
    n = (full.int() * (hi - lo)).cumsum(0).int()
    big_starts = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"), n])
    big_feats = torch.cat([feats[lo:hi].repeat(int(full.sum()), 1),
                           torch.zeros((256, feats.shape[1]), device="cuda")])
    before = tmarch.march.slot_launches
    got = tmarch.march(big_starts, big_feats, dirs_t.expand(T, R, 3).contiguous(), cfg, 256)
    one = tmarch.march(starts, feats, dirs_t, cfg, 256)
    empty_starts = torch.zeros(3, dtype=torch.int32, device="cuda")
    empty = tmarch.march(empty_starts, feats, dirs_t.expand(2, R, 3).contiguous(), cfg, 256)
    torch.cuda.synchronize()
    assert tmarch.march.slot_launches == before + 3
    for a, b, e in zip(got, one, empty):
        assert torch.equal(a[full], b.expand_as(a[full]))
        assert torch.equal(a[~full], e[:1].expand_as(a[~full]))
    _kernel_close(one, tmarch.march_plain(starts, feats, dirs_t, cfg, 256))
    _kernel_close(empty, tmarch.march_plain(empty_starts, feats,
                                            dirs_t.expand(2, R, 3).contiguous(), cfg, 256))


# --- K1 window order on the mesh path's modes: crafted block-mode and
# segment streams (tests/mesh_streams.py) --------------------------------------

# (mode, rays, SH degree, block_sub, window options): the 256-ray, 1024-ray
# and cluster builds (one ray a thread at 2048 rays, two at 16,384), with the
# span repair's band where the options ask for it
WINDOW_MESH_CASES = [
    ("block", 256, 0, 1, ""), ("block", 256, 3, 2, ""), ("block", 1024, 0, 2, ""),
    ("block", 1024, 3, 1, ""), ("block", 2048, 0, 1, ""), ("block", 2048, 3, 2, ""),
    ("block", 16384, 0, 2, ""), ("block", 16384, 3, 1, ""), ("block", 256, 0, 1, "band"),
    ("block", 2048, 3, 2, "band"), ("segment", 256, 0, 1, ""), ("segment", 1024, 3, 1, ""),
    ("segment", 2048, 0, 1, ""), ("segment", 16384, 3, 1, ""), ("segment", 256, 3, 1, "band")]
BAND = dict(sort_alpha_min=0.02, sort_repair=32)

# SHA-256 of K1's (rgb, t_final, fired, repaired) on each crafted call, from
# the kernels of commit 9d9cbcd (before the window kernel's block-mode sort
# and its dead-lane and segment-end exits), measured on an NVIDIA H100 80GB
# HBM3 (700.00 W) by _window_mesh_digests
WINDOW_MESH_DIGESTS = {
    "block R256 sh0 bsub1":
        "aea7f6eb5aff1f0adf8753a9cc7a59b46402a3b3172bd0f2461f456cbbcff2b4",
    "block R256 sh3 bsub2":
        "61f7497d8603ab89cd39da6b3a87ebaec771bd72139bea2a58de9e22fbf338c3",
    "block R1024 sh0 bsub2":
        "78558fb16756a87894a06d1ecfa56494949058907f93fef130fd720bf3618b31",
    "block R1024 sh3 bsub1":
        "d72b2809d57ea973594b333087b289699c50c247e00c59f8de5eac96b36d81a5",
    "block R2048 sh0 bsub1":
        "c0a05b6dd7e30f07534492e8b3a9f91ea7e054cfbe30d39b37c6a4bb6fb6eb1f",
    "block R2048 sh3 bsub2":
        "78ed9770d81a0aaa80531b3fd02624ab092628cc06dd098a04961c31d12655e4",
    "block R16384 sh0 bsub2":
        "1d4c77ff1d1540b592f7c74f9e532907766909956099399bfe6251eeadd26055",
    "block R16384 sh3 bsub1":
        "5023753a0353ab191fb00351921d62730b62190a96afe4b20fe14c78b526a18d",
    "block R256 sh0 bsub1 band":
        "aea7f6eb5aff1f0adf8753a9cc7a59b46402a3b3172bd0f2461f456cbbcff2b4",
    "block R2048 sh3 bsub2 band":
        "78ed9770d81a0aaa80531b3fd02624ab092628cc06dd098a04961c31d12655e4",
    "segment R256 sh0 bsub1":
        "6ee630efbbe2c4e0fa3c6a6eb124b4195426e7aa9f56b9b086033e075aea08fc",
    "segment R1024 sh3 bsub1":
        "0ec11c3b5443720f4ac0999e1673c35d325a82b2bd555076046dbac815d88556",
    "segment R2048 sh0 bsub1":
        "8401d4e53d5cde2781693ecf9e215a9b42daa57f686c97f6691353794af1e1da",
    "segment R16384 sh3 bsub1":
        "8c90567da025d295da65fc2c8b23bb41fff6af29cdcec36cc1b0c28705e5a915",
    "segment R256 sh3 bsub1 band":
        "5cb9e1423a7a14ec6b1bda46b5432d5220f252d0858a2300037dae2138116ea4",
}


def _window_mesh_call(case):
    from mesh_streams import crafted_call

    mode, rays, degree, bsub, opts = case
    return crafted_call(mode, rays, degree, block_sub=bsub, device="cuda",
                        **(BAND if opts == "band" else {}))


def _case_name(case) -> str:
    mode, rays, degree, bsub, opts = case
    return f"{mode} R{rays} sh{degree} bsub{bsub}" + (f" {opts}" if opts else "")


def _window_mesh_digest(case) -> str:
    import hashlib

    args, kw = _window_mesh_call(case)
    rgb, t_final, (fired, repaired) = tmarch.march(*args, **kw, stats=True)
    h = hashlib.sha256()
    for x in (rgb, t_final, fired, repaired):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _window_mesh_digests() -> dict:
    return {_case_name(case): _window_mesh_digest(case) for case in WINDOW_MESH_CASES}


@pytest.mark.parametrize("case", WINDOW_MESH_CASES, ids=_case_name)
def test_window_mesh_crafted_matches_plain_and_parent(case):
    """K1 window order on crafted block-mode and segment calls (reversed
    lists, equal keys, ns = C, ns of 0 to 2, dead lanes, dead warps, an all
    dead tile above the skip threshold, t_hi within two ulps of an entry;
    the span repair's band): at the K1 bars of the plain version, the
    per-tile fired and repaired chunks equal, two launches bit-identical,
    and the bits the kernels of commit 9d9cbcd gave (WINDOW_MESH_DIGESTS)."""
    args, kw = _window_mesh_call(case)
    counter = "block_launches" if case[0] == "block" else "segment_launches"
    before = getattr(tmarch.march, counter)
    got = tmarch.march(*args, **kw, stats=True)
    again = tmarch.march(*args, **kw, stats=True)
    torch.cuda.synchronize()
    assert getattr(tmarch.march, counter) == before + 2
    assert all(torch.equal(a, b) for a, b in zip((*got[:2], *got[2]), (*again[:2], *again[2])))
    want = tmarch.march_plain(*args, **kw, stats=True)
    _kernel_close(got[:2], want[:2])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)
    assert int(got[2][0].sum()) > 0 and float(got[1].min()) < 0.5
    if case[4] == "band":
        assert int(got[2][1].sum()) > 0  # the band's window sort ran
    assert _window_mesh_digest(case) == WINDOW_MESH_DIGESTS[_case_name(case)]



# --- K1 merge order's cluster build: crafted calls on tiles of 2048 to
# 16,384 rays (tests/merge_cluster_streams.py) ---------------------------------

# (mode, rays, SH degree, chunk, block_sub): one ray a thread at 2048 and 8192
# rays, two at 8320 (the second slot 128 rays, its other lanes idle) and
# 16,384; the quad response from the eye, the scalar and the quad response
# from per-ray origins, and block mode
MERGE_CLUSTER_CASES = [
    ("quad", 2048, 0, 128, 1), ("quad", 2048, 3, 64, 1), ("quad", 8192, 0, 32, 1),
    ("quad", 8320, 3, 128, 1), ("quad", 16384, 0, 64, 1), ("quad", 16384, 0, 128, 1),
    ("origin", 2048, 3, 128, 1), ("origin", 8320, 0, 64, 1), ("origin", 16384, 0, 128, 1),
    ("origin_quad", 2048, 0, 128, 1), ("origin_quad", 8192, 3, 64, 1),
    ("origin_quad", 16384, 0, 32, 1), ("block", 2048, 0, 128, 1), ("block", 8192, 3, 64, 2),
    ("block", 8320, 0, 128, 2), ("block", 16384, 3, 128, 1)]

# SHA-256 of K1's (rgb, t_final) on each crafted call, from the kernels of
# commit 309918a (before the merge kernel's cluster build was redesigned),
# measured on an NVIDIA H100 80GB HBM3 (700.00 W) by _merge_cluster_digests
MERGE_CLUSTER_DIGESTS = {
    "quad R2048 sh0 c128":
        "f3caf2eac97ef73bc6b228e5b5121e06e9c0a8921e6bc89cc0afc24cc2152361",
    "quad R2048 sh3 c64":
        "49b516f74e8cd8f3e7fbaa88f82875617eb3b9e50f49a157bd885f8fe9d2b943",
    "quad R8192 sh0 c32":
        "6229012257b95282338647740b67b57015a8f03632ba71079ea36484a83056b6",
    "quad R8320 sh3 c128":
        "fb210bea5bcad0353c6381e34c2759e484e4d3f877a084a2e78c40d23bd8200a",
    "quad R16384 sh0 c64":
        "c85e3cbd3b6f8ce4a574d1c2b54da4242470c5cdb8841125eb2819b9e2438068",
    "quad R16384 sh0 c128":
        "577ec613f806048016faebfeb325eb45f55756c335a04b127e0788e6ca6cd0e9",
    "origin R2048 sh3 c128":
        "0fcaf2ab6f649fa1bd93429ed40ceb51b9c76298117aa0e4287bb68790c085b5",
    "origin R8320 sh0 c64":
        "9258fb43390baab0a4aef02da3dfeaf4cbcbf2829886c710a8901918884bb9dc",
    "origin R16384 sh0 c128":
        "9d775b580667d2c9a0f24e97d827eb0c61edf34fd8907d306686fb8161ed1482",
    "origin_quad R2048 sh0 c128":
        "ffeb7511cd1d99d475cd4ceceae3a90db9ed83f3a13dca8cfe8c8da1e01e8dd6",
    "origin_quad R8192 sh3 c64":
        "80050feff47b3209740ce6bc506b4bd70617ed796e4320423b152a9ead696632",
    "origin_quad R16384 sh0 c32":
        "31dd583432b595b7807a73e104be918bf3dd94bf8463cf44dd59aa4ea086f591",
    "block R2048 sh0 c128":
        "6ab0a523ba702ba4e61049c8204a6e441ccf415d3ec196a73701b41e9da5f372",
    "block R8192 sh3 c64 bsub2":
        "4a61b057950ee60bfc6bc379779546645b5471358f7661b61ac6beb8cc992215",
    "block R8320 sh0 c128 bsub2":
        "daad255613b2c924ccce88d30587f8425b575705cee24ed6f9a3c4fa8b0b4cbd",
    "block R16384 sh3 c128":
        "09d317091d1b717b66c905338f6ee0cf27673d4fbbf6722ba8d425a61e5a8533",
}


def _merge_cluster_call(case):
    from merge_cluster_streams import crafted_merge_call

    mode, rays, degree, chunk, bsub = case
    return crafted_merge_call(mode, rays, degree, chunk, block_sub=bsub, device="cuda")


def _merge_case_name(case) -> str:
    mode, rays, degree, chunk, bsub = case
    return f"{mode} R{rays} sh{degree} c{chunk}" + (f" bsub{bsub}" if bsub > 1 else "")


def _merge_cluster_digest(case) -> str:
    import hashlib

    args, kw = _merge_cluster_call(case)
    h = hashlib.sha256()
    for x in tmarch.march(*args, **kw):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _merge_cluster_digests() -> dict:
    return {_merge_case_name(case): _merge_cluster_digest(case) for case in MERGE_CLUSTER_CASES}


@pytest.mark.parametrize("case", MERGE_CLUSTER_CASES, ids=_merge_case_name)
def test_merge_cluster_crafted_matches_plain_and_parent(case):
    """K1 merge order's cluster build on crafted calls (a tile whose every
    chunk passes the fast test, reversed chunks, a fresh buffer's first
    slow chunk, keys equal across the pending buffer and the chunk, chunks
    without a significant candidate, a tile the skip cuts off, random
    chunks with dead lanes; idle lanes past R at 8320): at the K1 bars of
    the plain version, two launches bit-identical, and the bits the kernels
    of commit 309918a gave (MERGE_CLUSTER_DIGESTS)."""
    args, kw = _merge_cluster_call(case)
    rays = case[1]
    counters = ("merge_launches", "cluster_launches", "slot_launches",
                "merge_block_launches")
    before = {c: getattr(tmarch.march, c) for c in counters}
    got = tmarch.march(*args, **kw)
    again = tmarch.march(*args, **kw)
    torch.cuda.synchronize()
    want = {"merge_launches": 2, "cluster_launches": 2, "slot_launches": 2 * (rays > 8192),
            "merge_block_launches": 2 * (case[0] == "block")}
    assert {c: getattr(tmarch.march, c) - before[c] for c in counters} == want
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = tmarch.march_plain(*args, **kw)
    _kernel_close(got, plain)
    assert 0 < tmarch.march_plain.slow < tmarch.march_plain.chunks
    assert float(got[1].min()) < 0.02 and float(got[1].max()) > 0.1
    assert _merge_cluster_digest(case) == MERGE_CLUSTER_DIGESTS[_merge_case_name(case)]


# --- K3 at 1024 rays and on the cluster builds: crafted calls on tiles of
# 1024 to 16,384 rays (tests/bwd_wide_streams.py) ----------------------------

# (order, origin, rays, SH degree, chunk, seed): the 1024-ray build; the
# cluster build at one ray a thread (2048, 8192) and at two (8320: the second
# slot 128 rays, its other lanes idle; 16,384); from the eye and from per-ray
# origins with windows; key order at any chunk, window order at 32-256. The
# seed of the data: the first of 0-3 on which the kernels of commit 1d2f322
# hold these bars (seed 0 of the key calls from the eye at 1024 and 2048
# rays puts them 1.41-1.44x as far from the float64 witness as the plain
# version, on one column)
K3_WIDE_CASES = [
    ("key", "eye", 1024, 0, 256, 1),
    ("window", "eye", 1024, 3, 128, 0),
    ("key", "origins", 1024, 3, 96, 0),
    ("window", "origins", 1024, 0, 64, 0),
    ("key", "eye", 2048, 0, 128, 1),
    ("window", "eye", 2048, 0, 128, 0),
    ("key", "origins", 2048, 0, 64, 0),
    ("window", "origins", 2048, 3, 128, 0),
    ("key", "eye", 8192, 3, 64, 0),
    ("window", "eye", 8192, 0, 32, 0),
    ("key", "eye", 8320, 0, 128, 0),
    ("window", "origins", 8320, 0, 64, 0),
    ("window", "eye", 8320, 3, 128, 0),
    ("key", "origins", 16384, 0, 128, 0),
    ("window", "eye", 16384, 0, 128, 0),
    ("key", "eye", 16384, 3, 256, 0),
]

# SHA-256 of K3's d_rows on each crafted call, from the kernels of commit
# 1d2f322 (before K3's 1024-ray and cluster builds were redesigned), taken on
# the card by `scripts/torch_redesign_ab.py --only bwd` (its "K3 crafted
# calls" row)
K3_WIDE_DIGESTS = {
    "key eye R1024 sh0 c256 s1":
        "7cbfacee26c8953fa50981542f516cb84bed4d8a5193f98a5118003032eb8771",
    "window eye R1024 sh3 c128 s0":
        "c9d1267752e92b1638377e3429e5615f853a10c4aa4aebd11bc6e06df6631c4e",
    "key origins R1024 sh3 c96 s0":
        "de33c0a01a73b3c2231d0669f22fa972e158f1c848c81c27b7b96582b8101a2b",
    "window origins R1024 sh0 c64 s0":
        "785dcbeb464f5335a3e29ba1644b4341c9854a377f517ac245be14b7d04f040c",
    "key eye R2048 sh0 c128 s1":
        "5f70419adf9f18d98090e54ac431deaa6e626326ce993b2c870abf29422e7ade",
    "window eye R2048 sh0 c128 s0":
        "044b16342eb1c30276e07fe1ec6051d5bf38db746560ab019c26cadc1ce0294c",
    "key origins R2048 sh0 c64 s0":
        "5560b68236a9d1004fc08f922fa4951e6c754b58a26cd46c7eb131d780c02508",
    "window origins R2048 sh3 c128 s0":
        "b2b04f820a915eda08282a8803a66b45eac962c1130e56a8ec07c01d3e720b30",
    "key eye R8192 sh3 c64 s0":
        "37ac86dfc7bed4dcff48968044f1ec69e65c6722793ab4657de61c308d77ee95",
    "window eye R8192 sh0 c32 s0":
        "2602772d16096b0790168f725ce299f287d422f84255d8ea26fe11e230006412",
    "key eye R8320 sh0 c128 s0":
        "11ea0f4ec9011abd3b23d241721ec8ebb95ea2eae887c84a6bb6ef4a70d64480",
    "window origins R8320 sh0 c64 s0":
        "2c461020b273e9a0ae39f9747cc97a49e5398e9f1921f398820109a6dfab8e90",
    "window eye R8320 sh3 c128 s0":
        "e9685586894c02b5d736ff1e3ec8c441063d2bfe2bf2aa149f9453c05c029dcc",
    "key origins R16384 sh0 c128 s0":
        "101d987e8811c913e67b15951b67a6a96486ff0b83b14ed9b27e4ef01b83048e",
    "window eye R16384 sh0 c128 s0":
        "600977c0c0b0e9ca835fb8aa14c06871f148ceac2ded58fd43dfb31d4ab96e5b",
    "key eye R16384 sh3 c256 s0":
        "29956e163961ad91ddf2cf1f96800ba7596df224819d43a971221a6fb61a6d6d",
}


def _k3_wide_call(case):
    from bwd_wide_streams import crafted_bwd_call

    order, origin, rays, degree, chunk, seed = case
    return crafted_bwd_call(order, origin, rays, degree, chunk, seed=seed, device="cuda")


def _k3_case_name(case) -> str:
    order, origin, rays, degree, chunk, seed = case
    return f"{order} {origin} R{rays} sh{degree} c{chunk} s{seed}"


def _k3_wide_digest(case) -> str:
    import hashlib

    args, kw = _k3_wide_call(case)
    return hashlib.sha256(tbwd.march_bwd(*args, **kw).contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


@pytest.mark.parametrize("case", K3_WIDE_CASES, ids=_k3_case_name)
def test_k3_wide_crafted_matches_plain_and_parent(case):
    """K3's 1024-ray and cluster builds on crafted calls (sure misses, every
    other candidate one, dd below 1e-6, a run of dead rays, candidates one
    ray alone gates, skipped and empty chunks, idle lanes at 8320): per
    written column at 1e-3 of march_bwd_plain (2e-3 on the 9 M columns), as
    close to the float64 witness as the plain version (1.25x), two launches
    bit-identical, and the bits the kernels of commit 1d2f322 gave
    (K3_WIDE_DIGESTS)."""
    args, kw = _k3_wide_call(case)
    rays, degree = case[2], case[3]
    counters = ("launches", "cluster_launches", "slot_launches", "origin_launches")
    before = {c: getattr(tbwd.march_bwd, c) for c in counters}
    a, b = tbwd.march_bwd(*args, **kw), tbwd.march_bwd(*args, **kw)
    torch.cuda.synchronize()
    want = {"launches": 2, "cluster_launches": 2 * (rays > 1024),
            "slot_launches": 2 * (rays > 8192), "origin_launches": 2 * (case[1] == "origins")}
    assert {c: getattr(tbwd.march_bwd, c) - before[c] for c in counters} == want
    assert torch.equal(a, b)
    plain = tbwd.march_bwd_plain(*args, **kw)
    f64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x
    witness = tbwd.march_bwd_plain(*map(f64, args), **{k: f64(v) for k, v in kw.items()})
    diff = tmarch.diff_columns(degree)
    for i, c in enumerate(tmarch.train_columns(degree)):
        if c not in diff:
            assert not a[:, i].any(), i
            continue
        bar = 2e-3 if tmarch.T_M0 <= i < tmarch.T_M0 + 9 else 1e-3
        assert float((a[:, i] - plain[:, i]).abs().max() / plain[:, i].abs().max()) <= bar, i
        k64, p64 = ((x[:, i] - witness[:, i]).abs().max() for x in (a, plain))
        assert float(k64) <= 1.25 * float(p64), i
    assert _k3_wide_digest(case) == K3_WIDE_DIGESTS[_k3_case_name(case)]
