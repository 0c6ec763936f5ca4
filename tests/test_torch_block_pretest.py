"""K4's pretests (ops/tri.block_may_hit, row_mask for the rows of 8
faces, face_may_hit), held against ground truth on seeded inputs: each
(ray, face) that Moller-Trumbore accepts in float32 (the plain version's
arithmetic) or in float64 at some t must find its block and its row kept
for the segment (t_min, next float above t), the weakest best_t under which
it would still win, and the face kept by the face pretest. The torch
functions are the kernel's rules operation for operation (csrc/tri.cu), so
what they keep, the kernel keeps.

Edge cases: rays tangent to a block's sphere, rays through face edges,
origins inside the spheres, a tail block of zero-padded faces, and rays
that graze faces (1e-2 to 1e-7 rad and 0 to their planes) of the sphere
near its silhouette and of a tilted, tessellated plane, where
Moller-Trumbore's t is mostly rounding. The cases off the faces' planes
also check that the pretests do skip (so they are exercised); the plain
version's result ignores the bounds, and `pretest_stats` counts what the
kernel runs."""

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu_torch.ops import tri as ttri
from gaussian_ray_tracing_tpu_torch.ops.intersect import moller_trumbore
from gaussian_ray_tracing_tpu_torch.scene.mesh import make_plane, make_sphere

torch.set_num_threads(1)
T_MIN, T_MAX = 1e-5, 1e5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# --- K4 ------------------------------------------------------------------

def _faces(mesh=None):
    """A 60 x 30 sphere (3,480 faces: 13 full blocks and a tail of 152
    faces and 104 zero-padded ones), or another mesh: its packed rows and
    block bounds."""
    mesh = make_sphere((0.0, 0.0, 1.0), tess_u=60, tess_v=30) if mesh is None else mesh
    wv, f = mesh.world_vertices(), mesh.faces.long()
    v = [wv[f[:, k]] for k in range(3)]
    rows, perm = ttri.pack_triangles(*v)
    findex = ttri.face_block_index(*v, perm)
    return rows, ttri.face_bounds(findex.centers, findex.radii, rows)


def _tilted_plane():
    """A 16 x 16 plane (512 faces), turned off the axes so that its
    arithmetic rounds."""
    plane = make_plane((0.0, 0.0, 0.0), width=2.0, height=2.0, tess_u=16, tess_v=16)
    wv, f = plane.world_vertices().double(), plane.faces
    rot = torch.linalg.matrix_exp(torch.tensor([[0.0, -0.3, 0.7], [0.3, 0.0, -0.2],
                                                [-0.7, 0.2, 0.0]], dtype=torch.float64))
    wv = (wv @ rot.T + torch.tensor([0.1, -0.2, 1.3], dtype=torch.float64)).float()
    v = [wv[f[:, k].long()] for k in range(3)]
    rows, perm = ttri.pack_triangles(*v)
    findex = ttri.face_block_index(*v, perm)
    return rows, ttri.face_bounds(findex.centers, findex.radii, rows)


def _k4_rays(rows, bounds, kind, n=384, seed=0):
    rng = np.random.default_rng(seed)
    c = np.array([0.0, 0.0, 1.0])
    if kind == "outside":  # a camera's rays at the sphere
        o = np.broadcast_to(np.array([0.1, 0.3, 2.6]), (n, 3))
        d = _unit(c - o + 0.22 * rng.normal(size=(n, 3)))
    elif kind == "inside":  # bounce rays: origins inside the sphere and its blocks
        o = c + 0.3 * _unit(rng.normal(size=(n, 3))) * rng.uniform(0.0, 1.0, (n, 1))
        d = _unit(rng.normal(size=(n, 3)))
    elif kind == "tangent":  # lines at exactly a block sphere's radius from its centre
        s = bounds[:, 0, 0].numpy()[rng.integers(0, bounds.shape[0], n)]
        d = _unit(rng.normal(size=(n, 3)))
        side = _unit(np.cross(d, rng.normal(size=(n, 3))))
        o = s[:, :3] + s[:, 3:] * side - rng.uniform(0.2, 2.0, (n, 1)) * d
    elif kind in ("fisheye", "opencv"):  # a wide camera's rays at the sphere, those it has
        from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
        from gaussian_ray_tracing_tpu_torch.config import CameraModel, RenderConfig

        cfg = (RenderConfig(camera_model=CameraModel.FISHEYE) if kind == "fisheye" else
               RenderConfig(camera_model=CameraModel.OPENCV, distortion=(-0.25, 0.05, 0.0, 0.0)))
        side = int(np.sqrt(n))
        cam = Camera.create(eye=(0.1, 0.3, 2.6), lookat=c, width=side, height=side)
        o, d, valid = generate_rays(cam, cfg)
        return o[valid].contiguous(), d[valid].contiguous()
    elif kind.startswith("graze"):  # through a point of a face, at an angle to its plane
        angle = float(kind.split("_")[-1])
        fr = rows.numpy().astype(np.float64)
        fr = fr[np.flatnonzero(np.linalg.norm(np.cross(fr[:, 3:6], fr[:, 6:]), axis=1) > 0)]
        fr = fr[rng.integers(0, fr.shape[0], n)]
        v0, e1, e2 = fr[:, :3], fr[:, 3:6], fr[:, 6:]
        w = rng.uniform(0.0, 1.0, (n, 2))
        w = np.where(w.sum(1, keepdims=True) > 1.0, 1.0 - w, w)
        p = v0 + w[:, :1] * e1 + w[:, 1:] * e2
        nrm = _unit(np.cross(e1, e2)).astype(np.float64)
        along = _unit(np.cross(nrm, rng.normal(size=(n, 3)))).astype(np.float64)
        d = _unit(np.cos(angle) * along + np.sin(angle) * rng.choice([-1.0, 1.0], (n, 1)) * nrm)
        o = p - rng.uniform(0.5, 3.0, (n, 1)) * d  # a camera's distance away
    else:  # "edges": rays through points on face edges, from either side
        fr = rows.numpy()[rng.integers(0, 3480, n)]
        v0, e1, e2 = fr[:, :3], fr[:, 3:6], fr[:, 6:]
        w = rng.uniform(0.0, 1.0, (n, 1))
        pick = rng.integers(0, 3, (n, 1))
        p = np.where(pick == 0, v0 + w * e1, np.where(pick == 1, v0 + w * e2,
                                                      v0 + w * e1 + (1 - w) * e2))
        d = _unit(np.cross(e1, e2) * rng.choice([-1.0, 1.0], (n, 1))
                  + 0.5 * rng.normal(size=(n, 3)))
        o = p - rng.uniform(0.01, 1.0, (n, 1)) * d
    return torch.from_numpy(np.ascontiguousarray(o, np.float32)), torch.from_numpy(
        np.ascontiguousarray(d, np.float32))


def _mt_hits(rows, o, d, dtype):
    """(R, F) accepted and t of every ray against every face row."""
    f = rows.to(dtype)[None]
    hit, t, _, _ = moller_trumbore(o.to(dtype)[:, None], d.to(dtype)[:, None], f[..., 0:3],
                                   f[..., 3:6], f[..., 6:9], T_MIN, T_MAX)
    return hit, t


GRAZE = [f"graze_{mesh}_{angle}" for mesh in ("sphere", "plane")
         for angle in ("1e-2", "1e-3", "1e-4", "1e-5", "1e-6", "1e-7", "0")]


@pytest.mark.parametrize("kind", ["outside", "inside", "tangent", "edges", "fisheye", "opencv"]
                         + GRAZE)
def test_k4_pretests_keep_every_accepted_hit(kind):
    """The camera kinds take a 32x32 fisheye (its pixels inside the image
    circle) or OpenCV camera's rays."""
    rows, bounds = _tilted_plane() if "plane" in kind else _faces()
    n_rays = 1024 if kind.startswith("graze") or kind in ("fisheye", "opencv") else 384
    o, d = _k4_rays(rows, bounds, kind, n=n_rays)
    blk = torch.arange(rows.shape[0]) // ttri.FACES_PER_BLOCK
    row = torch.arange(rows.shape[0]) % ttri.FACES_PER_BLOCK // ttri.SLOTS
    for dtype in (torch.float32, torch.float64):
        hit, t = _mt_hits(rows, o, d, dtype)
        ray, face = hit.nonzero(as_tuple=True)
        assert ray.numel() > 0
        t_hit = t[ray, face].to(torch.float32)
        # the weakest best_t under which the hit still wins: the next float up
        t_hi = torch.nextafter(t_hit, torch.tensor(float("inf")))
        bb = bounds[blk[face]]
        for hi in (t_hi, T_MAX):
            keep = ttri.block_may_hit(bb, o[ray], d[ray], T_MIN, hi)
            keep_row = ttri.row_mask(bb, o[ray], d[ray], T_MIN, hi)[torch.arange(ray.numel()),
                                                                     row[face]]
            assert bool(keep.all()), f"{kind} {dtype}: {int((~keep).sum())} hits in skipped blocks"
            assert bool(keep_row.all()), f"{kind} {dtype}: {int((~keep_row).sum())} in skipped rows"
    # the face pretest keeps every float32 hit (the kernel's arithmetic)
    hit, _ = _mt_hits(rows, o, d, torch.float32)
    det, nu = ttri._det_and_nu(o[:, None], d[:, None], rows[None])
    keep_face = ttri.face_may_hit(det, nu)
    assert bool(keep_face[hit].all())
    if kind.startswith("graze"):
        return
    assert float((~keep_face).float().mean()) > 0.3  # it does reject
    # with no hit yet, the block spheres reject many (ray, block) pairs; the
    # block pretest keeps those of them where the ray may graze a face of
    # one of the block's rows (this sphere's blocks are wide, its rows'
    # normals 10-20 degrees apart), and the row pretest rejects most (ray,
    # row) pairs of the blocks kept
    sph = bounds[None, :, 0, 0]
    ball = ttri.ball_may_hit(sph, ttri.slack_bound(sph, o[:, None]), o[:, None], d[:, None],
                             T_MIN, T_MAX)
    assert float((~ball).float().mean()) > (0.25 if kind == "inside" else 0.3)
    need = ttri.block_may_hit(bounds[None], o[:, None], d[:, None], T_MIN, T_MAX)
    assert bool((need >= ball).all()) and float((~need).float().mean()) > 0.03
    rows_kept = ttri.row_mask(bounds[None], o[:, None], d[:, None], T_MIN, T_MAX)[need]
    assert float((~rows_kept).float().mean()) > 0.5


def test_k4_cones_bound_every_face():
    """face_bounds' normal cones: for every face that Moller-Trumbore may
    accept (|e1| |e2| above 1e-12 / MAX_DIR), g >= |n -+ a| +
    GRAZE_ANGLE / sin(e1, e2) for its block's and its row's cone; the
    faces left out never pass the determinant guard; a row of zero-padded
    faces gets g = -1, and the sphere has pole faces with an edge of
    length 0."""
    rng = np.random.default_rng(5)
    for rows, bounds in (_faces(), _tilted_plane()):
        f = rows.double().reshape(-1, ttri.ROWS, ttri.SLOTS, 9)
        e1, e2 = f[..., 3:6], f[..., 6:9]
        l12 = e1.norm(dim=-1) * e2.norm(dim=-1)
        live = l12 * ttri.MAX_DIR > 1e-12
        out = rows[~live.reshape(-1)]
        d = torch.from_numpy(_unit(rng.normal(size=(64, 3)))) * ttri.MAX_DIR
        det, _ = ttri._det_and_nu(torch.zeros(64, 1, 3), d[:, None], out[None])
        assert not bool((det.abs() > 1e-12).any())
        n = torch.linalg.cross(e1, e2)
        sine = n.norm(dim=-1) / (e1.norm(dim=-1) * e2.norm(dim=-1))
        nh = n / n.norm(dim=-1, keepdim=True)
        for cone in (bounds[:, 0:1, 1].double().expand(-1, ttri.ROWS, -1)[:, :, None],
                     bounds[:, 1:, 1].double()[:, :, None]):
            a, g = cone[..., :3], cone[..., 3]
            dev = torch.minimum((nh - a).norm(dim=-1), (nh + a).norm(dim=-1))
            assert bool((g >= dev + ttri.GRAZE_ANGLE / sine)[live].all())
        dead = ~live.any(-1)
        assert bool((bounds[:, 1:, 1, 3][dead] == -1.0).all())
    rows, bounds = _faces()
    f = rows.reshape(-1, ttri.ROWS, ttri.SLOTS, 9)
    assert bool((f[-1, -1] == 0).all()) and float(bounds[-1, -1, 1, 3]) == -1.0  # padding
    assert bool(((f[..., 3:6] == 0).all(-1)).any())  # a pole face, never accepted


def test_k4_pretest_edge_geometry():
    """Exact cases: a ray just outside the grown sphere is rejected, one on
    it kept; a segment ending before or starting after the sphere is
    rejected, and one whose end reaches it kept; a dead ray is rejected; a
    ray across the cone's axis (it may graze a face) is kept anywhere, and
    a cone of g = -1 (no face may be accepted) never keeps one."""
    group = torch.tensor([[0.0, 0.0, 5.0, 1.0], [0.0, 0.0, 1.0, 0.5]])  # sphere, cone
    bnd = group.expand(1, 33, 2, 4).clone()  # a block whose rows share its bounds
    o, d = torch.zeros(1, 3), torch.tensor([[0.0, 0.0, 1.0]])
    rr = 1.0 * ttri.BLOCK_GROW + ttri.BLOCK_SLACK * (5.0 + 1.0)
    may = lambda o, d, lo=T_MIN, hi=T_MAX, b=bnd: bool(ttri.block_may_hit(b, o, d, lo, hi)[0])
    assert may(o, d)
    assert may(torch.tensor([[rr * 0.999, 0.0, 0.0]]), d)
    assert not may(torch.tensor([[rr * 1.001, 0.0, 0.0]]), d)
    assert not may(o, d, hi=5.0 - rr - 1e-3)  # ends before the sphere
    assert may(o, d, hi=5.0 - rr + 1e-3)
    assert not may(o, d, lo=5.0 + rr + 1e-3)  # starts after it
    assert not may(o, -d)  # the sphere lies at t < 0 < t_min
    assert not may(o, torch.zeros(1, 3))
    far, across = torch.tensor([[0.0, 50.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]])
    slant = torch.tensor([[0.8, 0.0, 0.6]])
    assert may(far, across)  # |d.a| = 0 < 0.5 |d|: it may graze
    assert not may(far, slant)  # |d.a| = 0.6 >= 0.5 |d|: the sphere decides
    wide = bnd.clone()
    wide[:, 0, 1, 3] = 2.0  # a block cone that proves nothing: its rows' cones decide
    assert not may(far, slant, b=wide)
    wide[:, 7, 1, 3] = 0.7
    assert may(far, slant, b=wide)
    assert ttri.row_mask(wide, far, slant, T_MIN, T_MAX)[0].nonzero().flatten().tolist() == [6]
    none = bnd.clone()
    none[:, :, 1] = torch.tensor([0.0, 0.0, 0.0, -1.0])
    assert not may(far, across, b=none)


def test_k4_plain_ignores_spheres_and_counts_skips():
    """The plain version's result does not depend on the bounds (the
    wrapper on the CPU is the plain version); pretest_stats, which the
    wrapper writes to `stats` on the CPU, counts a narrow beam's work on
    the 60 x 30 and the 180 x 90 sphere: the pretests skip rays, rows and
    faces, and on the finer sphere, whose blocks' rows it grazes less,
    whole blocks; no count exceeds the listed work."""
    for mesh in (None, make_sphere((0.0, 0.0, 1.0))):
        _count_beam(*_faces(mesh), fine=mesh is not None)


def _count_beam(rows, bounds, fine):
    rng = np.random.default_rng(4)  # two tiles of a narrow beam at the sphere's centre
    o = torch.tensor([[0.1, 0.3, 2.6]]).expand(64, 3).contiguous()
    d = torch.from_numpy(_unit(np.array([-0.1, -0.3, -1.6]) + 0.05 * rng.normal(size=(64, 3))))
    T = 2
    d_t, o_t = d.reshape(T, 32, 3), o.reshape(T, 32, 3)
    starts = torch.tensor([0, 14 * 256, 28 * 256], dtype=torch.int32)
    blocks = torch.cat([torch.arange(14), torch.arange(13, -1, -1)]).to(torch.int32)
    args = (starts, blocks, rows, d_t, torch.zeros(3), T_MIN, T_MAX, o_t)
    stats = torch.zeros((T, 5), dtype=torch.int32)
    a = ttri.closest_hit_blocks_plain(*args)
    b = ttri.closest_hit_blocks_plain(*args, bounds)
    c = ttri.closest_hit_blocks(*args, bounds=bounds, stats=stats)
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))
    assert torch.equal(stats, ttri.pretest_stats(*args, bounds))
    staged, needed, warp_blocks, warp_rows, divided = stats.long().sum(0).tolist()
    listed = 28  # (tile, block) pairs; one warp per tile
    assert 0 < staged <= listed and staged >= warp_blocks
    assert staged < listed or not fine
    assert 0 < needed < listed * 32
    assert 0 < warp_rows < warp_blocks * 32
    assert 0 < divided < warp_rows * 8 * 32
    with pytest.raises(ValueError):
        ttri.closest_hit_blocks(*args, bounds=bounds[:-1])
    with pytest.raises(ValueError):
        ttri.closest_hit_blocks(*args, bounds=bounds, stats=stats[:1])
