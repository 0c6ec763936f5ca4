"""Kernel K4's plain version (ops/tri.py) against the JAX package's
`pallas_closest_hit`, run in Pallas interpret mode as the JAX suite runs
it, on identical face rows and block streams; and against the port's
brute-force `closest_hit`, the independent witness.

Bars: packed face ids identical on every ray but the named boundary rays,
t at rtol 1e-5 (atol 1e-6), u and v at atol 1e-4. XLA's CPU backend
contracts a + b*c into FMAs, also inside the interpreted kernel, while the
port rounds each operation:

  - a ray whose float64 barycentrics sit within BARY_EPS of the tolerance
    bound against some face (an edge ray: both neighbours hit at about the
    same t), or whose two nearest float64 hits tie within TIE_REL, may take
    the other face on one side. Such rays are left out on both sides; they
    must stay a small share (measured: none of the 2,044 and 2,498 hit rays
    here);
  - u and v cancel: on faces 0.03 across, s.p and d.q are formed from terms
    ~100x their size, so both the interpreted kernel and the port sit up to
    ~2e-5 and ~5e-5 from a float64 evaluation of the same face (measured),
    and up to 6.3e-5 apart. An absolute bar is the meaningful one for a
    barycentric in [0, 1]; the kernel on the card is held to its plain
    version bit for bit instead (tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops import blocks as jblocks
from gaussian_ray_tracing_tpu.ops import pallas_tri as jtri
from gaussian_ray_tracing_tpu.scene import mesh as jmesh
from gaussian_ray_tracing_tpu_torch.ops import blocks as tblocks
from gaussian_ray_tracing_tpu_torch.ops import tri as ttri
from gaussian_ray_tracing_tpu_torch.ops.intersect import closest_hit

torch.set_num_threads(1)
T_MIN, T_MAX = 1e-5, 1e5
BARY_EPS, TIE_REL = 1e-5, 1e-5
BOUNDARY_SHARE = 0.05  # boundary rays: at most this share of the hit rays


def _to_jax_rows(face_rows: np.ndarray) -> np.ndarray:
    """(F_pad, 9) port rows -> the TPU kernel's (F_pad / 8, 128) packing."""
    return np.pad(face_rows, ((0, 0), (0, 7))).reshape(-1, 128)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def sphere_case():
    return _sphere_case()


def _sphere_case():
    """A 60 x 30 sphere (3,480 faces, 14 blocks) in front of a 64 x 48
    pinhole (12 tiles); bounce rays leave jittered origins on the sphere's
    near side in reflected-looking directions."""
    mesh = jmesh.make_sphere(np.array([0.0, 0.0, 1.0], np.float32), tess_u=60, tess_v=30)
    wv = np.asarray(mesh.world_vertices())
    f = np.asarray(mesh.faces)
    v = [wv[f[:, k]] for k in range(3)]
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 1.0), width=64, height=48,
                         fov_y_deg=20.0)
    _, dirs, _ = generate_rays(cam, JConfig())
    d_t = np.array(tile_rays(dirs, 16, 16))
    eye = np.array(cam.eye)
    rng = np.random.default_rng(7)
    o_b = (np.array([0.0, 0.0, 1.0]) + 0.45 * rng.normal(size=d_t.shape) / 3).astype(np.float32)
    d_b = (d_t + 0.3 * rng.normal(size=d_t.shape)).astype(np.float32)
    d_b /= np.linalg.norm(d_b, axis=-1, keepdims=True)
    return dict(v=v, eye=eye, shared=(d_t, None), per_ray=(d_b, o_b))


def _stream(case, dirs, origins, budget=16):
    """The JAX package's face rows and cone-culled block stream."""
    rows, perm = jtri.pack_triangles(*case["v"])
    findex = jtri.face_block_index(*case["v"], perm)
    o = np.broadcast_to(case["eye"], dirs.shape) if origins is None else origins
    bundles = jblocks.bundle_rays(o, dirs)
    vis = jblocks.cull_blocks(findex, bundles, T_MAX)
    T = dirs.shape[0]
    cap = T * 256 * min(budget, findex.centers.shape[0])
    return rows, perm, findex, jblocks.block_stream(vis, findex, bundles, cap, max_per_tile=budget)


def _boundary_rays(case, dirs, origins):
    """(T, R) bool, in float64 over every face (module docstring)."""
    v0, v1, v2 = (x.astype(np.float64) for x in case["v"])
    d = dirs.reshape(-1, 1, 3).astype(np.float64)
    o = (np.broadcast_to(case["eye"], dirs.shape) if origins is None else origins)
    o = o.reshape(-1, 1, 3).astype(np.float64)
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d, e2[None])
    det = np.sum(e1[None] * p, -1)
    inv = 1.0 / np.where(np.abs(det) > 1e-12, det, 1.0)
    s = o - v0[None]
    u = np.sum(s * p, -1) * inv
    q = np.cross(s, e1[None])
    w = np.sum(d * q, -1) * inv
    t = np.sum(e2[None] * q, -1) * inv
    in_t = (np.abs(det) > 1e-12) & (t > T_MIN) & (t < T_MAX)
    margin = np.minimum(np.minimum(u, w), 1.0 - u - w) + 1e-6  # 0 on the bound
    edge = (in_t & (np.abs(margin) < BARY_EPS)).any(-1)
    hit_t = np.sort(np.where(in_t & (margin >= 0), t, np.inf), -1)
    gap = np.where(np.isfinite(hit_t[:, 1]), hit_t[:, 1] - hit_t[:, 0], np.inf)
    tie = gap <= TIE_REL * hit_t[:, 0]
    return (edge | tie).reshape(dirs.shape[:2])


def test_pack_and_face_block_index_match_jax(sphere_case):
    v = [torch.from_numpy(x) for x in sphere_case["v"]]
    rows, perm = ttri.pack_triangles(*v)
    jrows, jperm = jtri.pack_triangles(*sphere_case["v"])
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    assert rows.shape == (14 * 256, 9)
    assert np.array_equal(_to_jax_rows(rows.numpy()), np.asarray(jrows))
    idx = ttri.face_block_index(*v, perm)
    jidx = jtri.face_block_index(*sphere_case["v"], jperm)
    np.testing.assert_allclose(idx.centers.numpy(), np.asarray(jidx.centers), rtol=1e-6)
    np.testing.assert_allclose(idx.radii.numpy(), np.asarray(jidx.radii), rtol=1e-6)


@pytest.mark.parametrize("rays", ["shared", "per_ray"])
def test_plain_closest_hit_matches_pallas(sphere_case, rays):
    dirs, origins = sphere_case[rays]
    jrows, _, _, stream = _stream(sphere_case, dirs, origins)
    T, R = dirs.shape[:2]
    want = jtri.pallas_closest_hit(stream.starts, stream.blk, jrows, dirs,
                                   jnp.asarray(sphere_case["eye"]), T_MIN, T_MAX, T, R,
                                   origins_t=origins, interpret=True)
    want = [np.asarray(x) for x in want]
    rows = torch.from_numpy(np.asarray(jrows).reshape(-1, 16)[:, :9].copy())
    got = ttri.closest_hit_blocks(_t(stream.starts), _t(stream.blk), rows, _t(dirs),
                                  _t(sphere_case["eye"]), T_MIN, T_MAX,
                                  None if origins is None else _t(origins))
    got = [x.numpy() for x in got]
    hit = want[1] >= 0
    assert 0.1 * hit.size < hit.sum() < hit.size  # hits and misses
    keep = ~_boundary_rays(sphere_case, dirs, origins)
    assert (~keep & hit).sum() <= BOUNDARY_SHARE * hit.sum()
    assert np.array_equal(got[1][keep], want[1][keep])
    np.testing.assert_array_equal(np.isinf(got[0]), np.isinf(want[0]))
    m = keep & hit
    np.testing.assert_allclose(got[0][m], want[0][m], rtol=1e-5, atol=1e-6)  # t
    for i in (2, 3):  # u, v
        np.testing.assert_allclose(got[i][m], want[i][m], rtol=0, atol=1e-4)


@pytest.mark.parametrize("rays", ["shared", "per_ray"])
def test_culled_closest_hit_matches_brute_force(sphere_case, rays):
    """With no block dropped by the budget, the culled K4 finds the same
    nearest t as the brute-force sweep over every face, bit for bit, and
    the same face up to exact t ties."""
    dirs, origins = sphere_case[rays]
    v = [torch.from_numpy(x) for x in sphere_case["v"]]
    rows, perm = ttri.pack_triangles(*v)
    findex = ttri.face_block_index(*v, perm)
    eye = _t(sphere_case["eye"])
    o = eye.expand(dirs.shape) if origins is None else _t(origins)
    bundles = tblocks.bundle_rays(o, _t(dirs))
    vis = tblocks.cull_blocks(findex, bundles, T_MAX)
    T = dirs.shape[0]
    stream = tblocks.block_stream(vis, findex, bundles, T * 256 * 14, max_per_tile=14)
    assert int(stream.n_dropped) == 0
    if origins is None:  # the bounce origins sit inside the sphere's blocks
        assert int(vis.sum()) < vis.numel()  # the cone cull does cull
    t, face, u, w = ttri.closest_hit_blocks(stream.starts, stream.blk, rows, _t(dirs), eye,
                                            T_MIN, T_MAX, None if origins is None else o)
    ref = closest_hit(o.reshape(-1, 3), _t(dirs).reshape(-1, 3), *v, T_MIN, T_MAX)
    assert torch.equal(t.reshape(-1), ref.t)
    orig = torch.where(face >= 0, perm[face.clamp(min=0).long()].to(torch.int32), -1)
    assert float((orig.reshape(-1) == ref.face).float().mean()) >= 0.99


def test_ties_follow_the_tpu_visit_order():
    """Duplicated triangles: an equal t goes to the first listed block,
    then to the lower slot (id % 8), then to the lower row, in the plain
    version as in the interpreted TPU kernel."""
    tri = np.array([[-0.5, -0.5, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], np.float32)  # v0 e1 e2
    rows = np.zeros((2 * 256, 9), np.float32)
    for fid in (1, 40, 26, 58):  # (row 0, slot 1), (5, 0), (3, 2), (7, 2)
        rows[fid] = tri
    rows[256 + 3] = tri  # block 1, (row 0, slot 3)
    R = 32
    dirs = np.zeros((3, R, 3), np.float32)
    dirs[..., 2] = -1.0
    eye = np.array([-0.25, -0.25, 1.0], np.float32)
    starts = np.array([0, 512, 768, 1280], np.int32)  # 2, 1 and 2 listed blocks
    blocks = np.array([0, 1, 1, 1, 0], np.int32)
    want = jtri.pallas_closest_hit(starts, blocks, _to_jax_rows(rows), dirs, eye, T_MIN, T_MAX,
                                   3, R, interpret=True)
    got = ttri.closest_hit_blocks(_t(starts), _t(blocks), _t(rows), _t(dirs), _t(eye),
                                  T_MIN, T_MAX)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    # tile 0 lists [0, 1]: block 0 wins, slot 0 beats slot 1 -> id 40;
    # tile 1 lists [1]: id 256 + 3; tile 2 lists [1, 0]: block 1 first
    assert got[1][:, 0].tolist() == [40, 259, 259]
    assert bool((got[0] == 1.0).all())


def test_wrapper_runs_the_plain_version_on_cpu(sphere_case):
    dirs, origins = sphere_case["per_ray"]
    v = [torch.from_numpy(x) for x in sphere_case["v"]]
    rows, perm = ttri.pack_triangles(*v)
    args = (torch.tensor([0, 256, 512], dtype=torch.int32), torch.tensor([2, 9], dtype=torch.int32),
            rows, _t(dirs[:2]), _t(sphere_case["eye"]), T_MIN, T_MAX, _t(origins[:2]))
    before = ttri.closest_hit_blocks.launches
    a = ttri.closest_hit_blocks(*args)
    b = ttri.closest_hit_blocks_plain(*args)
    assert ttri.closest_hit_blocks.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        ttri.closest_hit_blocks(args[0][:-1], *args[1:])
    with pytest.raises(ValueError):
        ttri.closest_hit_blocks(args[0], args[1], rows[:100], *args[3:])
