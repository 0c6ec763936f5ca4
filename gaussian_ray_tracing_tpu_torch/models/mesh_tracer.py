"""Secondary-ray tracer: gaussians plus inserted triangle meshes with mirror,
glass and normal bounces (counterpart of
gaussian_ray_tracing_tpu/models/mesh_tracer.py).

A bounded bounce loop over the whole tiled ray batch carries the
reference's per-ray payload: accumulated colour and alpha, direct light,
blocking radiance, the bounce count and the gaussian transmittance across
segments. Per bounce:

  - mesh MISS -> final gaussian pass over [t_min, t_max]:
        directLight = radiance_seg * density_total, accumAlpha += density
  - mesh HIT  -> gaussian pass over [t_min, t_hit]:
        accumColor += (1 - accumAlpha) * radiance_seg, accumAlpha and
        blockingRadiance += density, then the ray continues reflected
        (MIRROR), refracted or totally reflected (GLASS), or stops after
        compositing the normal colour (NORMAL);
  - both then add directLight * (1 - blockingRadiance).

`render_with_mesh_fast`: every bounce culls the Morton face blocks per tile
and runs the closest-hit kernel K4 (ops/tri.py), which also gets the face
blocks' and rows' bounds (bounding spheres and normal cones) for its
per-ray pretests; bounce 0 marches the
screen-space pair stream with K1 in segment mode (per-ray t_hi at the hit,
carry-in T); later bounces march the Morton-sorted gaussian table with K1
in block mode (per-ray origins, scalar response). `render_with_mesh_planar_
mirror`: one planar MIRROR rectangle; bounce 1 is the frame of the
reflected camera (at the frame's camera model), so it runs K1 twice in
segment mode and no K4.
`render_with_mesh_oracle`: the exact reference on flat ray batches
(`render_rays_with_mesh`), every bounce a brute-force closest hit
(ops/intersect.closest_hit) and an exact per-ray-sorted gaussian segment
(models/oracle.render_rays_oracle), plain torch on the scene's device, any
camera model and SH degree. `render_with_mesh` picks the oracle when told
to, else the planar-mirror or the fast path. The fast and planar paths
take every camera model and SH degree 0-3 too: bounce 0 marches the
camera's own rays on the quad SH rows, the bounced block march the scalar
SH rows, and K1 evaluates the colour from each ray's own (reflected or
refracted) direction; pixels without a ray (fisheye, outside the image
circle) have direction 0, are never live, and stay black. `use_kernels=
False` runs the plain torch versions of the kernels on any device.

The JAX package's `lax.cond(any live)` between bounces is one host-read
bool per bounce here. Liveness inside a bounce uses max(min_transmittance,
chunk_skip_transmittance); the test between bounces min_transmittance only,
as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import (
    MeshType, RenderConfig, check_mesh_supported, chunk_for,
)
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
    check_devices, frame_image, prepare_pair_stream, snug_pair_capacity,
)
from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays, untile_image
from gaussian_ray_tracing_tpu_torch.ops.blocks import (
    block_stream, build_block_index, bundle_rays, cull_blocks,
)
from gaussian_ray_tracing_tpu_torch.models.oracle import frame_from_rays, render_rays_oracle
from gaussian_ray_tracing_tpu_torch.ops.intersect import closest_hit, reflect, refract_or_tir
from gaussian_ray_tracing_tpu_torch.ops.march import march, march_plain
from gaussian_ray_tracing_tpu_torch.ops.response import adaptive_radius, dot3
from gaussian_ray_tracing_tpu_torch.ops.tiles import count_pairs, num_tiles
from gaussian_ray_tracing_tpu_torch.ops.tri import (
    FACES_PER_BLOCK, closest_hit_blocks, closest_hit_blocks_plain, face_block_index,
    face_bounds, pack_triangles,
)
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene
from gaussian_ray_tracing_tpu_torch.scene.mesh import TriangleMesh

_I32 = torch.int32


def _surface_interaction(d, normal, hit_t, has_hit, face, face_types, rgb_seg, density_total,
                         accum_color, accum_alpha, bounces, config: RenderConfig,
                         glass_ratio: float):
    """Per-ray surface response with per-face material types (-1, or no
    types at all, defers to config.mesh_type). Returns (new_d, new_bounces,
    t_shift, terminate_hit, accum_color, accum_alpha); NORMAL's compositing
    is applied here, after the caller's generic hit accumulation."""
    mt = int(config.mesh_type)
    if face_types is None:
        t_id = torch.full(has_hit.shape, mt, dtype=_I32, device=has_hit.device)
    else:
        t_id = face_types[torch.clamp(face, min=0).long()]
        t_id = torch.where(t_id < 0, mt, t_id)
    is_m = t_id == int(MeshType.MIRROR)
    is_g = t_id == int(MeshType.GLASS)
    is_n = t_id == int(MeshType.NORMAL)

    glass_d, reflected = refract_or_tir(d, normal, glass_ratio)
    new_d = torch.where(is_n[..., None], d,
                        torch.where(is_g[..., None], glass_d, reflect(d, normal)))
    new_bounces = bounces + torch.where(is_m, 1, torch.where(is_g, reflected.to(_I32), 0))
    t_shift = hit_t + torch.where(is_g & ~reflected, config.refraction_eps_shift, 0.0)
    terminate_hit = has_hit & is_n
    # NORMAL: the gaussian segment plus the normal colour at the remaining
    # transmittance, alpha saturated
    add = rgb_seg + (normal + 1.0) * 0.5 * (1.0 - density_total)[..., None]
    accum_color = torch.where(terminate_hit[..., None],
                              accum_color - (1.0 - accum_alpha)[..., None] * rgb_seg + add,
                              accum_color)
    accum_alpha = torch.where(terminate_hit,
                              torch.clamp(accum_alpha + (1.0 - density_total), 0.0, 1.0),
                              accum_alpha)
    return new_d, new_bounces.to(_I32), t_shift, terminate_hit, accum_color, accum_alpha


def _interp_normal(mesh_n, faces, face, u, v):
    """Barycentric vertex-normal interpolation for flat hit arrays (a miss,
    face -1, reads the last face, as the JAX indexing does)."""
    f = faces[face.long()]
    n0, n1, n2 = (mesh_n[f[:, k].long()] for k in range(3))
    n = (1.0 - u - v)[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def _new_payload(o: torch.Tensor, d: torch.Tensor) -> dict:
    """The reference's per-ray payload before the first bounce (`...` is the
    ray batch): origin, direction, accumulated colour and alpha, direct
    light, blocking radiance, bounce count, gaussian transmittance, done."""
    z = lambda dtype=torch.float32: torch.zeros(d.shape[:-1], dtype=dtype, device=d.device)
    return dict(o=o, d=d, accum_color=torch.zeros_like(d), direct_light=torch.zeros_like(d),
                accum_alpha=z(), blocking=z(), bounces=z(_I32), trans=z() + 1.0,
                done=z(torch.bool))


def _bounce(p: dict, live, has_hit, t_hit, face, normal, rgb_seg, t_next, face_types,
            config: RenderConfig, glass_ratio: float) -> dict:
    """The payload after one bounce's gaussian segment (tracer.cu:59-106):
    a miss is the final gaussian pass (direct light), a hit adds the
    segment and the blocking radiance, then the surface interaction; both
    add the direct light through (1 - blocking)."""
    e = lambda x: x[..., None]
    clamp01 = lambda x: torch.clamp(x, 0.0, 1.0)
    density_total = 1.0 - t_next
    miss = live & ~has_hit
    direct_light = torch.where(e(miss), rgb_seg * e(density_total), p["direct_light"])
    accum_alpha = torch.where(miss, clamp01(p["accum_alpha"] + density_total), p["accum_alpha"])
    accum_color = torch.where(e(has_hit), p["accum_color"] + e(1.0 - accum_alpha) * rgb_seg,
                              p["accum_color"])
    accum_alpha = torch.where(has_hit, clamp01(accum_alpha + density_total), accum_alpha)
    blocking = torch.where(has_hit, clamp01(p["blocking"] + density_total), p["blocking"])
    new_d, new_bounces, t_shift, terminate_hit, accum_color, accum_alpha = _surface_interaction(
        p["d"], normal, t_hit, has_hit, face, face_types, rgb_seg, density_total, accum_color,
        accum_alpha, p["bounces"], config, glass_ratio)
    # on the final miss blocking holds its pre-miss value
    accum_color = torch.where(e(live), accum_color + direct_light * e(1.0 - blocking), accum_color)
    return dict(o=torch.where(e(has_hit), p["o"] + e(t_shift) * p["d"], p["o"]),
                d=torch.where(e(has_hit & ~terminate_hit), new_d, 0.0),
                accum_color=accum_color, direct_light=direct_light, accum_alpha=accum_alpha,
                blocking=blocking, bounces=torch.where(has_hit, new_bounces, p["bounces"]),
                trans=t_next, done=p["done"] | miss | terminate_hit | ~live)


def render_rays_with_mesh(scene: GaussianScene, mesh: TriangleMesh, origins: torch.Tensor,
                          dirs: torch.Tensor, config: RenderConfig, loop_bound: int = 8,
                          ray_chunk: int = 4096):
    """Trace a flat ray batch (R, 3) through mesh bounces and exact gaussian
    segments (module docstring; the reference's per-ray payload). The whole
    bounce loop runs per chunk of `ray_chunk` rays; loop_bound caps the
    bounces (the reference's per-ray loop runs to 32). A bounce marches only
    its live rays: a dead ray's segment adds nothing and keeps its T, and
    once no ray is live no later bounce changes anything. Returns
    (accum_color (R, 3), accum_alpha (R,))."""
    R = origins.shape[0]
    if R > ray_chunk:
        parts = [render_rays_with_mesh(scene, mesh, origins[s:s + ray_chunk],
                                       dirs[s:s + ray_chunk], config, loop_bound, ray_chunk)
                 for s in range(0, R, ray_chunk)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    mesh = mesh.to(origins.device)
    wv, wn = mesh.world_vertices(), mesh.world_normals()
    faces = mesh.faces.long()
    v0, v1, v2 = wv[faces[:, 0]], wv[faces[:, 1]], wv[faces[:, 2]]
    glass_ratio = config.glass_ior / config.air_ior
    p = _new_payload(origins, dirs)
    for _ in range(loop_bound):
        o, d, trans = p["o"], p["d"], p["trans"]
        live = ((~p["done"]) & (torch.sum(d * d, dim=-1) > 0.01)
                & (p["bounces"] < config.max_bounces) & (trans > config.min_transmittance))
        if not bool(live.any()):
            break
        hit = closest_hit(o, d, v0, v1, v2, config.mesh_t_min, config.mesh_t_max)
        has_hit = hit.hit & live
        seg_hi = torch.where(has_hit, hit.t, config.t_max)
        idx = live.nonzero().squeeze(1)
        rgb_seg, t_next = torch.zeros_like(d), trans.clone()
        rgb_seg[idx], _, t_next[idx] = render_rays_oracle(
            scene, o[idx], d[idx], config, t_lo=config.t_min, t_hi=seg_hi[idx], t0=trans[idx],
            ray_chunk=ray_chunk)
        p = _bounce(p, live, has_hit, hit.t, hit.face,
                    _interp_normal(wn, faces, hit.face, hit.u, hit.v), rgb_seg, t_next,
                    mesh.face_types, config, glass_ratio)
    return p["accum_color"], p["accum_alpha"]


def render_with_mesh_oracle(scene: GaussianScene, mesh: TriangleMesh, camera: Camera,
                            config: RenderConfig = RenderConfig(), loop_bound: int = 8,
                            ray_chunk: int = 4096) -> dict:
    """Full-frame mesh render on the exact oracle (the reference's
    semantics, O(rays x gaussians) per bounce): {rgb (H, W, 3) in [0, 1],
    alpha (H, W)}, on the scene's device."""
    origins, dirs, valid = generate_rays(camera, config)
    rgb, alpha = render_rays_with_mesh(scene, mesh, origins.reshape(-1, 3), dirs.reshape(-1, 3),
                                       config, loop_bound=loop_bound, ray_chunk=ray_chunk)
    return frame_from_rays(rgb, alpha, valid)


def render_with_mesh_fast(scene: GaussianScene, mesh: TriangleMesh, camera: Camera,
                          config: RenderConfig = RenderConfig(), loop_bound: int = 4,
                          pair_capacity: int | None = None, block_capacity: int | None = None,
                          chunk: int | None = None, use_kernels: bool = True,
                          record: list | None = None):
    """Full-frame mesh render, every bounce through K4 and K1 (module
    docstring). Returns {rgb, alpha, aux: {block_dropped, pair_dropped}};
    block_dropped counts the gaussian and face slots the per-tile budgets
    left out, as the JAX package does. With a `record` list, each bounce
    appends {"k4": (args, kwargs), "k1": (args, kwargs)}: the inputs of its
    two kernel calls, so a check can hold the kernels against their plain
    versions at this path's own shapes."""
    check_mesh_supported(config)
    check_devices(scene, camera, use_kernels)
    mesh = mesh.to(scene.device)
    k1 = march if use_kernels else march_plain
    k4 = closest_hit_blocks if use_kernels else closest_hit_blocks_plain
    if chunk is None:
        chunk = chunk_for(config)
    if pair_capacity is None:
        pair_capacity = snug_pair_capacity(int(count_pairs(scene, camera, config)))
    tx, ty = num_tiles(camera, config)
    n_tiles = tx * ty
    if block_capacity is None:
        # a hard per-tile budget of bounce_block_budget near-to-far blocks
        block_capacity = n_tiles * chunk * config.bounce_block_budget
    block_capacity = (block_capacity // chunk) * chunk

    stream, pair_feats, _, rows, bound_radius = prepare_pair_stream(
        scene, camera, config, pair_capacity, use_kernels, with_table=True)
    index = build_block_index(scene.means, bound_radius, block_size=chunk)
    # Morton-sorted training rows, padded by one chunk of zero rows (alpha 0)
    sorted_rows = torch.cat([rows[index.perm], rows.new_zeros((chunk, rows.shape[1]))])

    _, dirs, valid = generate_rays(camera, config)
    d_t = tile_rays(dirs, config.tile_w, config.tile_h)
    o_t = camera.eye.expand(d_t.shape)
    eye = camera.eye.to(torch.float32)

    wn = mesh.world_normals()
    faces = mesh.faces.long()
    wv = mesh.world_vertices()
    v0, v1, v2 = wv[faces[:, 0]], wv[faces[:, 1]], wv[faces[:, 2]]
    glass_ratio = config.glass_ior / config.air_ior
    face_rows, tri_perm = pack_triangles(v0, v1, v2)
    findex = face_block_index(v0, v1, v2, tri_perm)
    fbounds = face_bounds(findex.centers, findex.radii, face_rows)
    face_capacity = n_tiles * FACES_PER_BLOCK * min(16, findex.centers.shape[0])
    n_faces = faces.shape[0]
    bounce_cfg = config.replace(order=config.bounce_order)
    bsub = max(1, config.bounce_blocks_per_chunk)
    skip_live = max(config.min_transmittance, config.chunk_skip_transmittance)

    p = _new_payload(o_t, d_t)
    drops = torch.zeros((), dtype=_I32, device=d_t.device)

    for bounce in range(loop_bound):
        o_t, d_t, trans = p["o"], p["d"], p["trans"]
        moving = ((~p["done"]) & (torch.sum(d_t * d_t, dim=-1) > 0.01)
                  & (p["bounces"] < config.max_bounces))
        if bounce and not bool((moving & (trans > config.min_transmittance)).any()):
            break  # every later bounce would leave the state as it is
        live = moving & (trans > skip_live)
        d_live = torch.where(live[..., None], d_t, 0.0)
        bundles = bundle_rays(o_t, d_live)
        fstream = block_stream(cull_blocks(findex, bundles, config.mesh_t_max), findex, bundles,
                               face_capacity,
                               max_per_tile=max(1, face_capacity // (n_tiles * FACES_PER_BLOCK)))
        # bounce 0: every ray starts at the eye (the shared-origin variant)
        k4_call = ((fstream.starts, fstream.blk, face_rows, d_live, eye, config.mesh_t_min,
                    config.mesh_t_max),
                   dict(origins_t=None if bounce == 0 else o_t, bounds=fbounds))
        t_hit, fpk, hu, hv = k4(*k4_call[0], **k4_call[1])
        face = torch.where((fpk >= 0) & (fpk < n_faces),
                           tri_perm[torch.clamp(fpk, 0, n_faces - 1).long()].to(_I32), -1)
        has_hit = (face >= 0) & live
        seg_hi = torch.where(has_hit, t_hit, config.t_max)
        drops = drops + fstream.n_dropped

        if bounce == 0:
            k1_call = ((stream.starts, pair_feats, d_live, config, chunk),
                       dict(t_hi=seg_hi, t0=trans))
        else:
            # per-tile t cap: nothing beyond the tile's farthest live
            # segment end can contribute
            t_cap = torch.where(live, seg_hi, 0.0).amax(dim=-1)
            bstream = block_stream(cull_blocks(index, bundles, t_cap), index, bundles,
                                   block_capacity,
                                   max_per_tile=max(1, block_capacity // (n_tiles * chunk)))
            drops = drops + bstream.n_dropped
            k1_call = ((bstream.starts, sorted_rows, d_live, bounce_cfg, chunk * bsub),
                       dict(origins_t=o_t, t_hi=seg_hi, t0=trans, blocks=bstream.blk,
                            block_sub=bsub))
        if record is not None:
            record.append({"k4": k4_call, "k1": k1_call})
        rgb_seg, t_next = k1(*k1_call[0], **k1_call[1])
        normal = _interp_normal(wn, faces, face.reshape(-1), hu.reshape(-1),
                                hv.reshape(-1)).reshape(d_t.shape)
        p = _bounce(p, live, has_hit, t_hit, face, normal, rgb_seg, t_next, mesh.face_types,
                    config, glass_ratio)

    out = frame_image(p["accum_color"], p["accum_alpha"], valid, camera, config)
    out["aux"] = {"block_dropped": int(drops), "pair_dropped": int(stream.n_dropped)}
    return out


def planar_mirror_plane(mesh: TriangleMesh, config: RenderConfig):
    """A single planar MIRROR rectangle (the reference's headline demo), or
    None: the active faces are coplanar, all effectively MIRROR, and tile
    their in-plane bounding rectangle (so point-in-rect is an exact hit
    test). Returns the plane data (unit normal n, offset d, in-plane basis
    b1/b2, rect bounds) as numpy float32."""
    wv = mesh.world_vertices().detach().cpu().numpy()
    faces = mesh.faces.cpu().numpy()[: mesh.num_faces]
    if faces.shape[0] == 0:
        return None
    if mesh.face_types is None:
        if int(config.mesh_type) != int(MeshType.MIRROR):
            return None
    else:
        ft = mesh.face_types.cpu().numpy()[: mesh.num_faces]
        if not (np.where(ft < 0, int(config.mesh_type), ft) == int(MeshType.MIRROR)).all():
            return None
    v0, v1, v2 = wv[faces[:, 0]], wv[faces[:, 1]], wv[faces[:, 2]]
    cr = np.cross(v1 - v0, v2 - v0)
    areas = 0.5 * np.linalg.norm(cr, axis=-1)
    if (areas < 1e-12).any():
        return None
    n0 = cr[np.argmax(areas)]
    n0 = n0 / np.linalg.norm(n0)
    pv = wv[np.unique(faces.reshape(-1))]
    d0 = float(np.median(pv @ n0))
    if np.abs(pv @ n0 - d0).max() > 1e-4 * max(1.0, float(np.abs(pv).max())):
        return None
    e = v1[0] - v0[0]
    b1 = e - float(e @ n0) * n0
    b1 = b1 / np.linalg.norm(b1)
    b2 = np.cross(n0, b1)
    c1, c2 = pv @ b1, pv @ b2
    lo1, hi1, lo2, hi2 = c1.min(), c1.max(), c2.min(), c2.max()
    bbox_area = (hi1 - lo1) * (hi2 - lo2)
    # the triangles must tile the rect, else the rect test over-reports hits
    if bbox_area <= 0 or abs(areas.sum() - bbox_area) > 1e-3 * bbox_area:
        return None
    f = np.float32
    return dict(n=np.asarray(n0, f), d=f(d0), b1=np.asarray(b1, f), b2=np.asarray(b2, f),
                lo1=f(lo1), hi1=f(hi1), lo2=f(lo2), hi2=f(hi2))


def render_with_mesh_planar_mirror(scene: GaussianScene, camera: Camera, config: RenderConfig,
                                   plane: dict, pair_capacity: int | None = None,
                                   chunk: int | None = None, use_kernels: bool = True,
                                   record: list | None = None):
    """Planar-mirror path: all rays reflected off a plane pass through the
    reflected eye with the same |d| per pixel, so bounce 1 is the frame of
    the mirrored camera at the config's camera model (built with the
    mirrored up vector, which lands primary pixel (x, y) at mirror pixel
    (W-1-x, y): exact for pinhole and fisheye rays, and under OpenCV only
    while the tangential p2 is 0, as in the JAX package), marched with
    per-ray windows [t_hit + t_min, t_max] and the primary segment's
    transmittance as its carry-in. Gaussians wholly behind the mirror are
    dropped from that frame. A plane-reflected ray cannot hit the plane
    again, so bounce 1 is every hit ray's final pass.
    Returns {rgb, alpha, aux: {pair_dropped}}; a `record` list gets
    {"k1": (args, kwargs)} of each of its two K1 calls, as in
    render_with_mesh_fast."""
    check_mesh_supported(config)
    check_devices(scene, camera, use_kernels)
    k1 = march if use_kernels else march_plain
    if chunk is None:
        chunk = chunk_for(config)
    dev = scene.device
    vec = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    nv, b1, b2 = vec(plane["n"]), vec(plane["b1"]), vec(plane["b2"])
    d = float(plane["d"])
    dot = lambda x, a: dot3([x[..., k] for k in range(3)], [a[k] for k in range(3)])
    t3 = lambda x: tile_rays(x, config.tile_w, config.tile_h)
    t2 = lambda x: t3(x[..., None])[..., 0]
    untile = lambda x: untile_image(x, camera.height, camera.width, config.tile_w, config.tile_h)
    capacity = lambda s, c: pair_capacity or snug_pair_capacity(int(count_pairs(s, c, config)))

    # primary pass: analytic closest hit of the plane rectangle
    _, dirs, valid = generate_rays(camera, config)
    eye = camera.eye.to(torch.float32)
    ndot = dot(dirs, nv)
    live0 = torch.sum(dirs * dirs, dim=-1) > 0.01
    t_plane = (d - dot(eye, nv)) / torch.where(torch.abs(ndot) > 1e-12, ndot, float("inf"))
    p_hit = eye + t_plane[..., None] * dirs
    c1, c2 = dot(p_hit, b1), dot(p_hit, b2)
    hit = (live0 & (t_plane >= config.mesh_t_min) & (t_plane <= config.mesh_t_max)
           & (c1 >= float(plane["lo1"])) & (c1 <= float(plane["hi1"]))
           & (c2 >= float(plane["lo2"])) & (c2 <= float(plane["hi2"])))
    stream, feats, _ = prepare_pair_stream(scene, camera, config, capacity(scene, camera),
                                           use_kernels)
    seg_hi = torch.where(hit, t_plane, config.t_max)
    calls = [((stream.starts, feats, t3(dirs), config, chunk), dict(t_hi=t2(seg_hi)))]
    rgb0_t, t0_t = k1(*calls[0][0], **calls[0][1])
    rgb0, t_after0 = untile(rgb0_t), untile(t0_t[..., None])[..., 0]
    density0 = 1.0 - t_after0

    # bounce 1: the mirrored camera's frame
    refl = lambda p: p - 2.0 * (dot(p, nv) - d) * nv
    m_r = lambda v: v - 2.0 * dot(v, nv) * nv
    host = lambda x: x.cpu().numpy()
    cam_m = Camera.create(eye=host(refl(eye)), lookat=host(refl(camera.lookat)),
                          up=host(m_r(camera.up)), fov_y_deg=camera.fov_y_deg,
                          width=camera.width, height=camera.height, device=dev)
    side = torch.sign(dot(eye, nv) - d)
    bound_r = adaptive_radius(scene.opacities, config.alpha_min) * torch.amax(scene.scales, -1)
    behind = side * (dot(scene.means, nv) - d) < -bound_r
    scene_m = GaussianScene(means=scene.means, scales=scene.scales, quats=scene.quats,
                            opacities=torch.where(behind, 0.0, scene.opacities), sh=scene.sh,
                            num_active=scene.num_gaussians)
    stream_m, feats_m, _ = prepare_pair_stream(scene_m, cam_m, config, capacity(scene_m, cam_m),
                                               use_kernels)
    _, dirs_m, _ = generate_rays(cam_m, config)
    flip = lambda img: torch.flip(img, dims=(1,))
    hit_m = flip(hit)
    # same |d| per mirrored pixel, so the same t: the window starts at the
    # plane hit + t_min, the carry-in is the primary segment's T
    t_lo_m = torch.where(hit_m, flip(t_plane) + config.t_min, float("inf"))
    t0_m = torch.where(hit_m, flip(t_after0), 0.0)
    calls.append(((stream_m.starts, feats_m, t3(dirs_m), config, chunk),
                  dict(t_lo=t2(t_lo_m), t0=t2(t0_m))))
    rgb1_t, t1_t = k1(*calls[1][0], **calls[1][1])
    if record is not None:
        record.extend({"k1": call} for call in calls)
    rgb1 = flip(untile(rgb1_t))
    density1 = 1.0 - flip(untile(t1_t[..., None])[..., 0])  # cumulative (carry t0)

    # render_with_mesh_fast's bookkeeping for one mirror bounce
    miss = live0 & ~hit
    rgb = torch.where(miss[..., None], rgb0 * density0[..., None], 0.0)
    alpha = torch.where(miss, density0, 0.0)
    blocking = torch.clamp(density0, 0.0, 1.0)
    rgb = torch.where(hit[..., None],
                      rgb0 + rgb1 * density1[..., None] * (1.0 - blocking)[..., None], rgb)
    alpha = torch.where(hit, torch.clamp(blocking + density1, 0.0, 1.0), alpha)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    return {"rgb": torch.where(valid[..., None], rgb, 0.0),
            "alpha": torch.where(valid, alpha, 0.0),
            "aux": {"pair_dropped": int(stream.n_dropped) + int(stream_m.n_dropped)}}


def render_with_mesh(scene: GaussianScene, mesh: TriangleMesh, camera: Camera,
                     config: RenderConfig = RenderConfig(), use_kernels: bool = True,
                     oracle: bool = False, **kw):
    """Full-frame render with mesh bounces: with `oracle`, the exact oracle
    (kw: loop_bound, ray_chunk; it drops nothing); else the planar-mirror
    path when the mesh is one planar MIRROR rectangle and no loop_bound is
    given, else the fast path (kw: loop_bound, pair_capacity,
    block_capacity, chunk); both take a `record` list."""
    if oracle:
        out = render_with_mesh_oracle(scene, mesh, camera, config, **kw)
        return {**out, "aux": {"block_dropped": 0, "pair_dropped": 0}}
    plane = planar_mirror_plane(mesh, config)
    if plane is not None and "loop_bound" not in kw:
        return render_with_mesh_planar_mirror(scene, camera, config, plane,
                                              use_kernels=use_kernels, **kw)
    return render_with_mesh_fast(scene, mesh, camera, config, use_kernels=use_kernels, **kw)
