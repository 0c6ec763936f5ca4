"""The port's mesh modules against the JAX package: scene/mesh.py (builders,
world vertices and normals, merge with face types: exact), ops/intersect.py
(reflect, refract: rtol 1e-6; the brute-force closest hit) and
ops/blocks.py (Morton codes and the block index: exact order and codes,
centres and radii at rtol 1e-6; bundles, cull and block stream: identical
block lists, starts and drop counts). Inputs are made with numpy from a
seed and handed to both sides."""

import jax
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.config import MeshType as JMeshType
from gaussian_ray_tracing_tpu.ops import blocks as jblocks
from gaussian_ray_tracing_tpu.ops import intersect as jintersect
from gaussian_ray_tracing_tpu.scene import mesh as jmesh
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.config import MeshType
from gaussian_ray_tracing_tpu_torch.ops import blocks as tblocks
from gaussian_ray_tracing_tpu_torch.ops import intersect as tintersect
from gaussian_ray_tracing_tpu_torch.scene import mesh as tmesh
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

torch.set_num_threads(1)
MESH_FIELDS = ("vertices", "normals", "faces", "transform")
CUBE_V = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1), (-1, -1, 1), (1, -1, 1),
          (1, 1, 1), (-1, 1, 1)]
CUBE_F = [(1, 2, 3), (1, 3, 4), (5, 7, 6), (5, 8, 7), (1, 5, 6), (1, 6, 2), (2, 6, 7),
          (2, 7, 3), (3, 7, 8), (3, 8, 4), (4, 8, 5), (4, 5, 1)]


def write_cube_obj(path, with_normals=False):
    """The JAX suite's OBJ cube (tests/test_pallas.py TestObjMesh), half-size 0.4;
    optionally with per-corner `vn` lines and v//vn faces."""
    lines = [f"v {x * 0.4} {y * 0.4} {z * 0.4}" for x, y, z in CUBE_V]
    if with_normals:
        lines += [f"vn {x} {y} {z}" for x, y, z in CUBE_V]
        lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in CUBE_F]
    else:
        lines += [f"f {a} {b} {c}" for a, b, c in CUBE_F]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _assert_same_mesh(t, j):
    for k in MESH_FIELDS:
        assert np.array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k))), k
    assert t.num_faces == j.num_faces
    assert (t.face_types is None) == (j.face_types is None)
    if t.face_types is not None:
        assert np.array_equal(t.face_types.numpy(), np.asarray(j.face_types))
    assert np.array_equal(t.world_vertices().numpy(), np.asarray(j.world_vertices()))
    np.testing.assert_allclose(t.world_normals().numpy(), np.asarray(j.world_normals()),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["plane", "plane_tess", "sphere", "sphere_full", "obj",
                                  "obj_vn"])
def test_builders_match_jax(kind, tmp_path):
    pos = np.array([0.1, -0.2, 1.2], np.float32)
    if kind == "plane":
        pair = (tmesh.make_plane(pos), jmesh.make_plane(pos))
    elif kind == "plane_tess":
        pair = (tmesh.make_plane(pos, 1.2, 1.0, 3, 2), jmesh.make_plane(pos, 1.2, 1.0, 3, 2))
    elif kind == "sphere":
        pair = (tmesh.make_sphere(pos, tess_u=24, tess_v=12),
                jmesh.make_sphere(pos, tess_u=24, tess_v=12))
    elif kind == "sphere_full":  # the reference's 180 x 90 sphere: 32,040 faces
        pair = (tmesh.make_sphere(pos), jmesh.make_sphere(pos))
        assert pair[0].num_faces == 32_040
    else:
        path = write_cube_obj(tmp_path / "cube.obj", with_normals=kind == "obj_vn")
        pair = (tmesh.load_obj(path, pos), jmesh.load_obj(path, pos))
        assert pair[0].num_faces == 12
    _assert_same_mesh(*pair)


def test_transform_type_merge_and_numpy_round_trip():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    xf = np.eye(4, dtype=np.float32)
    xf[:3, :3] = (1.7 * q).astype(np.float32)  # rotation and uniform scale
    xf[:3, 3] = rng.normal(size=3).astype(np.float32)
    t_plane = tmesh.make_plane((0.0, 0.0, 1.0), 2.0, 1.0).with_transform(xf)
    j_plane = jmesh.make_plane((0.0, 0.0, 1.0), 2.0, 1.0).with_transform(xf)
    _assert_same_mesh(t_plane, j_plane)
    t_sph = tmesh.make_sphere((0.3, 0.0, 0.0), tess_u=8, tess_v=5)
    j_sph = jmesh.make_sphere((0.3, 0.0, 0.0), tess_u=8, tess_v=5)
    for typed in (False, True):
        tm = [t_plane.with_type(MeshType.GLASS), t_sph] if typed else [t_plane, t_sph]
        jm = [j_plane.with_type(JMeshType.GLASS), j_sph] if typed else [j_plane, j_sph]
        merged = tmesh.merge_meshes(tm)
        _assert_same_mesh(merged, jmesh.merge_meshes(jm))
        if typed:  # the untyped sphere defers to config.mesh_type
            assert set(merged.face_types.tolist()) == {int(MeshType.GLASS), -1}
    back = tmesh.TriangleMesh.from_numpy(merged.to_numpy(), merged.num_faces)
    _assert_same_mesh(back, jmesh.merge_meshes(jm))


def test_reflect_and_refract_match_jax():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    td, tn = torch.from_numpy(d), torch.from_numpy(n)
    np.testing.assert_allclose(tintersect.reflect(td, tn).numpy(),
                               np.asarray(jintersect.reflect(d, n)), rtol=1e-6, atol=1e-6)
    for ratio in (1.5 / 1.0003, 1.0003 / 1.5):
        got, tir = tintersect.refract_or_tir(td, tn, ratio)
        want, jtir = jintersect.refract_or_tir(d, n, ratio)
        assert np.array_equal(tir.numpy(), np.asarray(jtir))
        assert 0 < int(tir.sum()) < len(d) or ratio > 1.0  # some rays reflect internally
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.2, 2.6]) + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, size=(n, 3)) + np.array([0.0, 0.0, 1.0])
    d = target - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_brute_force_closest_hit_matches_jax():
    mesh = jmesh.make_sphere(np.array([0.0, 0.0, 1.0], np.float32), tess_u=24, tess_v=12)
    wv = np.asarray(mesh.world_vertices())
    f = np.asarray(mesh.faces)
    v0, v1, v2 = wv[f[:, 0]], wv[f[:, 1]], wv[f[:, 2]]
    o, d = _rays(2048, 2)
    want = jintersect.closest_hit(o, d, v0, v1, v2, 1e-5, 1e5, face_chunk=128)
    got = tintersect.closest_hit(*(torch.from_numpy(x) for x in (o, d, v0, v1, v2)),
                                 1e-5, 1e5, face_chunk=128)
    face = np.asarray(want.face)
    assert 0.2 * len(o) < (face >= 0).sum() < len(o)  # hits and misses
    # XLA contracts a + b*c into FMAs where the port rounds each operation:
    # a ray on a shared edge or a near-tie may take the neighbour face
    same = got.face.numpy() == face
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same], rtol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-4)


@pytest.fixture(scope="module")
def scene_points():
    js = j_random_scene(3000, seed=9)
    means = np.array(js.means)  # writable, for torch.from_numpy
    bound = np.random.default_rng(3).uniform(0.0, 0.05, size=means.shape[0]).astype(np.float32)
    return means, bound


def test_morton_codes_and_block_index_match_jax(scene_points):
    means, bound = scene_points
    dup = np.concatenate([means, means[:500]])  # equal codes: the sort must be stable
    assert np.array_equal(tblocks.morton_codes(torch.from_numpy(dup)).numpy(),
                          np.asarray(jblocks.morton_codes(dup)))
    assert np.array_equal(tblocks.morton_order(torch.from_numpy(dup)).numpy(),
                          np.asarray(jax.numpy.argsort(jblocks.morton_codes(dup))))
    for bs in (128, 256):
        got = tblocks.build_block_index(torch.from_numpy(means), torch.from_numpy(bound), bs)
        want = jblocks.build_block_index(means, bound, bs)
        assert got.block_size == want.block_size == bs
        assert np.array_equal(got.perm.numpy(), np.asarray(want.perm))
        np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), rtol=1e-6)
        np.testing.assert_allclose(got.radii.numpy(), np.asarray(want.radii), rtol=1e-6)


def test_block_bounds_contain_gaussians():
    """Port of tests/test_pallas.py TestBlocks: every block sphere holds its
    gaussians' bounding spheres."""
    scene = random_scene(1000, seed=9)
    n = scene.num_gaussians
    idx = tblocks.build_block_index(scene.means, torch.full((n,), 0.05), block_size=128)
    sorted_means = scene.means[idx.perm]
    for b in range(idx.centers.shape[0]):
        seg = sorted_means[b * 128:(b + 1) * 128]
        dist = torch.linalg.norm(seg - idx.centers[b], dim=-1)
        assert bool((dist + 0.05 <= idx.radii[b] + 1e-5).all())


def test_morton_locality():
    pts = random_scene(4000, seed=2).means
    pts = pts[tblocks.morton_order(pts)].numpy()
    adj = np.linalg.norm(np.diff(pts, axis=0), axis=-1).mean()
    rperm = np.random.default_rng(0).permutation(len(pts) - 1)
    assert adj < 0.5 * np.linalg.norm(pts[:-1] - pts[rperm], axis=-1).mean()


def _bounce_rays(n_tiles, R, seed):
    """Tiled bounced rays: origins scattered over a mirror patch, reflected
    directions, with a share of dead (zero-direction) rays."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n_tiles, R, 3), np.float32)
    o[..., :2] = rng.uniform(-0.6, 0.6, size=(n_tiles, 1, 2)) + 0.05 * rng.normal(
        size=(n_tiles, R, 2))
    o[..., 2] = 1.0
    d = np.stack([0.3 * rng.normal(size=(n_tiles, R)), 0.3 * rng.normal(size=(n_tiles, R)),
                  -np.ones((n_tiles, R))], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[rng.uniform(size=(n_tiles, R)) < 0.2] = 0.0
    d[3] = 0.0  # one wholly dead tile
    return o, d


@pytest.mark.parametrize("per_tile_cap,budget", [(False, 16), (True, 16), (False, 3)])
def test_bundles_cull_and_stream_match_jax(scene_points, per_tile_cap, budget):
    means, bound = scene_points
    bs = 128
    o, d = _bounce_rays(12, 256, seed=4)
    jidx = jblocks.build_block_index(means, bound, bs)
    tidx = tblocks.build_block_index(torch.from_numpy(means), torch.from_numpy(bound), bs)
    jb = jblocks.bundle_rays(o, d)
    tb = tblocks.bundle_rays(torch.from_numpy(o), torch.from_numpy(d))
    for k in ("o_c", "o_r", "axis", "cos_half"):
        np.testing.assert_allclose(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)),
                                   rtol=1e-5, atol=1e-6)
    assert np.array_equal(tb.any_live.numpy(), np.asarray(jb.any_live))
    t_cap = np.linspace(0.5, 3.0, 12).astype(np.float32) if per_tile_cap else 1e5
    jvis = jblocks.cull_blocks(jidx, jb, t_cap)
    tvis = tblocks.cull_blocks(tidx, tb, torch.as_tensor(t_cap))
    assert np.array_equal(tvis.numpy(), np.asarray(jvis))
    assert 0 < int(tvis.sum()) < tvis.numel()
    cap = 12 * bs * budget
    js = jblocks.block_stream(jvis, jidx, jb, cap, max_per_tile=budget)
    ts = tblocks.block_stream(tvis, tidx, tb, cap, max_per_tile=budget)
    for k in ("blk", "starts", "n_slots", "n_dropped"):
        assert np.array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k))), k
    if budget == 3:  # the budget clips the farthest blocks of the tile
        assert int(ts.n_dropped) > 0
