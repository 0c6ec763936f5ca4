"""Triangle meshes for secondary-ray (mirror/normal/glass) effects
(counterpart of gaussian_ray_tracing_tpu/scene/mesh.py).

The reference's reflection primitives: a tessellated plane (0.3 x 0.5), a
UV sphere (tessU=180, tessV=90, r=0.3) and OBJ loading with the reference's
Y-flip on positions and normals. A mesh carries a 4x4 object-to-world
transform; world normals are the object normals times its upper 3x3,
renormalized, as the reference's host upload does. Builders run in numpy
and hand float32 tensors over, so a mesh built here equals the JAX one bit
for bit (`from_numpy` / `to_numpy` carry one across as it is).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_FIELDS = ("vertices", "normals", "faces", "transform")


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Triangle soup.

    vertices (V, 3) and normals (V, 3) in object space, faces (F, 3) int32
    vertex indices, transform (4, 4) object-to-world. Faces at index >=
    num_faces are padding. face_types (F,) int32 per-face MeshType, -1 (or
    None for the whole mesh) defers to config.mesh_type.
    """

    vertices: torch.Tensor
    normals: torch.Tensor
    faces: torch.Tensor
    transform: torch.Tensor
    num_faces: int = 0
    face_types: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def to(self, device) -> "TriangleMesh":
        ft = None if self.face_types is None else self.face_types.to(device)
        return dataclasses.replace(
            self, face_types=ft, **{k: getattr(self, k).to(device) for k in _FIELDS})

    def world_vertices(self) -> torch.Tensor:
        # elementwise, in the JAX package's association order
        R, v = self.transform[:3, :3], self.vertices
        return (v[:, 0:1] * R[:, 0][None] + v[:, 1:2] * R[:, 1][None]
                + v[:, 2:3] * R[:, 2][None] + self.transform[:3, 3][None])

    def world_normals(self) -> torch.Tensor:
        """Normals times the transform's upper 3x3 (not its inverse
        transpose, as the reference does), renormalized."""
        R, nv = self.transform[:3, :3], self.normals
        n = nv[:, 0:1] * R[:, 0][None] + nv[:, 1:2] * R[:, 1][None] + nv[:, 2:3] * R[:, 2][None]
        return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)

    def with_transform(self, transform) -> "TriangleMesh":
        t = torch.as_tensor(np.asarray(transform, np.float32), device=self.device)
        return dataclasses.replace(self, transform=t)

    def with_type(self, mesh_type) -> "TriangleMesh":
        """Stamp one material type on every face of this mesh."""
        ft = torch.full((self.faces.shape[0],), int(mesh_type), dtype=torch.int32,
                        device=self.device)
        return dataclasses.replace(self, face_types=ft)

    @staticmethod
    def from_numpy(arrays: dict, num_faces: int, device="cpu") -> "TriangleMesh":
        """Wrap arrays (vertices, normals, faces, transform and optional
        face_types) as they are."""
        t = {k: torch.tensor(np.asarray(arrays[k], np.int32 if k == "faces" else np.float32),
                             device=device) for k in _FIELDS}
        ft = arrays.get("face_types")
        if ft is not None:
            ft = torch.tensor(np.asarray(ft, np.int32), device=device)
        return TriangleMesh(**t, num_faces=int(num_faces), face_types=ft)

    def to_numpy(self) -> dict:
        out = {k: getattr(self, k).cpu().numpy() for k in _FIELDS}
        out["face_types"] = None if self.face_types is None else self.face_types.cpu().numpy()
        return out


def _build(vertices, normals, faces, position, device="cpu") -> TriangleMesh:
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(position, np.float32)
    return TriangleMesh.from_numpy(
        dict(vertices=np.asarray(vertices, np.float32), normals=np.asarray(normals, np.float32),
             faces=faces, transform=t), faces.shape[0], device=device)


def make_plane(position=(0.0, 0.0, 0.0), width=0.3, height=0.5, tess_u=1, tess_v=1,
               device="cpu") -> TriangleMesh:
    """Tessellated XY plane facing +Z."""
    u_tile, v_tile = width / tess_u, height / tess_v
    corner = np.array([-width * 0.5, -height * 0.5, 0.0], np.float32)
    verts, norms = [], []
    for j in range(tess_v + 1):
        for i in range(tess_u + 1):
            verts.append(corner + np.array([i * u_tile, j * v_tile, 0.0], np.float32))
            norms.append(np.array([0.0, 0.0, 1.0], np.float32))
    faces = []
    stride = tess_u + 1
    for j in range(tess_v):
        for i in range(tess_u):
            a, b = j * stride + i, j * stride + i + 1
            c, d = (j + 1) * stride + i + 1, (j + 1) * stride + i
            faces += [[a, b, c], [c, d, a]]
    return _build(verts, norms, faces, position, device)


def make_sphere(position=(0.0, 0.0, 0.0), radius=0.3, tess_u=180, tess_v=90,
                device="cpu") -> TriangleMesh:
    """UV sphere, south-pole-up ordering, 2 * tess_u * (tess_v - 1) faces."""
    phis = 2.0 * np.pi * np.arange(tess_u + 1) / tess_u
    thetas = np.pi * np.arange(tess_v) / (tess_v - 1)
    st, ct = np.sin(thetas)[:, None], np.cos(thetas)[:, None]
    sp, cp = np.sin(phis)[None, :], np.cos(phis)[None, :]
    normals = np.stack([cp * st, np.broadcast_to(ct, (tess_v, tess_u + 1)), sp * st], -1)
    normals = normals.reshape(-1, 3).astype(np.float32)
    verts = normals * radius
    cols = tess_u + 1
    lat, lon = np.meshgrid(np.arange(tess_v - 1), np.arange(tess_u), indexing="ij")
    ll = (lat * cols + lon).reshape(-1)
    lr, ur, ul = ll + 1, ll + cols + 1, ll + cols
    faces = np.stack([np.stack([ll, lr, ur], -1), np.stack([ur, ul, ll], -1)], 1)
    return _build(verts, normals, faces, position, device)


def load_obj(path: str, position=(0.0, 0.0, 0.0), device="cpu") -> TriangleMesh:
    """Minimal OBJ loader (v/vn/f, fan-triangulated), with the reference's
    Y-flip on positions and normals, expanded to one vertex per face corner."""
    positions, normals_in, tri_v, tri_n = [], [], [], []
    with open(path, "r") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                positions.append([float(t[1]), -float(t[2]), float(t[3])])
            elif t[0] == "vn":
                normals_in.append([float(t[1]), -float(t[2]), float(t[3])])
            elif t[0] == "f":
                refs = []
                for tok in t[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else vi
                    refs.append((vi, ni))
                for k in range(1, len(refs) - 1):
                    tri_v.append((refs[0][0], refs[k][0], refs[k + 1][0]))
                    tri_n.append((refs[0][1], refs[k][1], refs[k + 1][1]))
    positions = np.asarray(positions, np.float32)
    normals_in = np.asarray(normals_in, np.float32)
    index = lambda i, n: i - 1 if i > 0 else n + i  # 1-based, negatives from the end
    verts = [positions[index(vi, len(positions))] for fv in tri_v for vi in fv]
    if len(normals_in):
        norms = [normals_in[index(ni, len(normals_in))] for fn in tri_n for ni in fn]
    else:
        norms = [np.zeros(3, np.float32)] * len(verts)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return _build(np.reshape(verts, (-1, 3)), np.reshape(norms, (-1, 3)), faces, position,
                  device)


def merge_meshes(meshes: list[TriangleMesh]) -> TriangleMesh:
    """Bake world transforms and concatenate into one world-space mesh.

    Per-face types are carried over; meshes without them get -1 (defer to
    config.mesh_type). If no input carries types, face_types stays None."""
    verts, norms, faces, types = [], [], [], []
    offset = 0
    any_types = any(m.face_types is not None for m in meshes)
    for m in meshes:
        v = m.world_vertices().cpu().numpy()
        verts.append(v)
        norms.append(m.world_normals().cpu().numpy())
        faces.append(m.faces[: m.num_faces].cpu().numpy() + offset)
        offset += v.shape[0]
        if any_types:
            types.append(np.full((m.num_faces,), -1, np.int32) if m.face_types is None
                         else m.face_types[: m.num_faces].cpu().numpy())
    device = meshes[0].device
    out = _build(np.concatenate(verts), np.concatenate(norms), np.concatenate(faces),
                 (0.0, 0.0, 0.0), device)
    if any_types:
        out = dataclasses.replace(
            out, face_types=torch.as_tensor(np.concatenate(types), device=device))
    return out
