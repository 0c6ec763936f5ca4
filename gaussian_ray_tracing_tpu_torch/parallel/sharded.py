"""Sharded renderers over a parallel/mesh.Mesh (counterpart of
gaussian_ray_tracing_tpu/parallel/sharded.py).

Three strategies, as in the JAX package:

  1. rays sharded over the 'rays' axis, gaussians replicated:
     `render_rays_sharded_oracle` (flat rays, exact), `render_tiled_sharded`
     (the tiled march, differentiable by autograd), `render_pallas_sharded`
     (the production forward on K1 and K2: each shard bins only its band of
     tile rows) and `render_pallas_sharded_diff` (the training render:
     K1 with saved carries forward and K3 backward over each shard's slice
     of one replicated pair stream);
  2. gaussians depth-slab partitioned over the 'gauss' axis: each shard
     composites its own contiguous view-depth slab with carry-in
     transmittance 1, and an ordered front-to-back fold combines the slabs
     (`combine_slab_segments`, exact because radiance is linear in the
     carry-in): `render_gaussian_sharded` (the oracle per slab; 1-D or
     rays x gauss meshes), `render_gaussian_sharded_fast` (the tiled march
     per slab; straddle "slab" or "exact"), `render_gaussian_ring` (ray
     blocks passed around a ring, two carried partials) and
     `render_pallas_slabs` (K1 and K2 per slab; comm "gather" or "ring");
  3. any of them across processes (parallel/distributed.py): the same
     functions on a mesh that spans torch.distributed ranks.

Every function loops over the shards of its process and returns the whole
frame on the first local shard's device (in every process). Work that
JAX replicates on every device (the O(N) per-gaussian prep) runs once per
process and is copied to the shards' devices. The kernels are reached
through their wrappers (ops/march.march, ops/march_bwd, ops/scan via
ops/tiles.bin_pairs), which launch the CUDA kernels on CUDA tensors and
run the plain versions on CPU tensors, so a CPU mesh runs the plain
versions and a CUDA mesh the kernels, never one for the other. The JAX
table's pad to 128 columns is TPU layout and not ported.
"""

from __future__ import annotations

import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera, generate_rays
from gaussian_ray_tracing_tpu_torch.config import (
    RenderConfig, check_supported, check_tiled_supported, check_trainable, chunk_for,
    train_config,
)
from gaussian_ray_tracing_tpu_torch.models import tiled
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import (
    bin_footprints, check_devices, frame_image, prepare_pair_stream, prepare_train_stream,
    snug_pair_capacity,
)
from gaussian_ray_tracing_tpu_torch.models.oracle import frame_from_rays, render_rays_oracle
from gaussian_ray_tracing_tpu_torch.ops.march import compact_features, march
from gaussian_ray_tracing_tpu_torch.ops.march_bwd import march_stream_diff
from gaussian_ray_tracing_tpu_torch.ops.response import adaptive_radius
from gaussian_ray_tracing_tpu_torch.ops.tiles import (
    footprint_pair_count, num_tiles, project_footprints_conic,
)
from gaussian_ray_tracing_tpu_torch.parallel.mesh import (
    GAUSS_AXIS, RAY_AXIS, Mesh, all_gather, pmax, ppermute, psum,
)
from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

_FIELDS = ("means", "scales", "quats", "opacities", "sh")


def _pad_leading(x: torch.Tensor, size: int, value=0) -> torch.Tensor:
    """x with its leading dim padded to `size` with `value`."""
    pad = size - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])


def _gather_rays(mesh: Mesh, parts: list) -> torch.Tensor:
    """The per-shard blocks along the ray axis (one per local shard),
    concatenated in ray order on the first local shard's device."""
    if RAY_AXIS not in mesh.shape:
        return parts[0]
    whole = all_gather(mesh, parts, RAY_AXIS)[0]
    return whole.reshape(-1, *whole.shape[2:])


def _local_rays(mesh: Mesh):
    """(shard, its index along 'rays' (0 without that axis), its device)
    for each local shard."""
    has = RAY_AXIS in mesh.shape
    return [(s, mesh.index(s, RAY_AXIS) if has else 0, mesh.device(s)) for s in mesh.local]


def _frame(rgb_t, t_final_t, valid, camera: Camera, config: RenderConfig,
           alpha_t=None) -> dict:
    """Untile (T, R) tile rows into the frame on valid's device; alpha is
    1 - t_final unless given."""
    alpha_t = 1.0 - t_final_t if alpha_t is None else alpha_t
    return frame_image(rgb_t.to(valid.device), alpha_t.to(valid.device), valid, camera, config)


def render_rays_sharded_oracle(scene: GaussianScene, origins: torch.Tensor, dirs: torch.Tensor,
                               config: RenderConfig, mesh: Mesh, ray_chunk: int = 1024):
    """Exact oracle render with flat rays sharded over 'rays'. Returns rgb
    (R, 3), density (R,), t_final (R,)."""
    n = mesh.shape[RAY_AXIS]
    R = origins.shape[0]
    size = -(-R // (n * ray_chunk)) * n * ray_chunk
    o_p, d_p = _pad_leading(origins, size), _pad_leading(dirs, size)
    per = size // n
    outs = [render_rays_oracle(scene.to(dev), o_p[i * per:(i + 1) * per].to(dev),
                               d_p[i * per:(i + 1) * per].to(dev), config, ray_chunk=ray_chunk)
            for _, i, dev in _local_rays(mesh)]
    return tuple(_gather_rays(mesh, [o[k] for o in outs])[:R] for k in range(3))


def render_tiled_sharded(scene: GaussianScene, camera: Camera, config: RenderConfig,
                         mesh: Mesh, tile_chunk: int | None = None,
                         pair_capacity: int | None = None, xla_rounding: bool = False):
    """The tiled march (models/tiled.py) with image tiles sharded over
    'rays'. Binning runs once per process; each shard marches its block of
    tiles. Differentiable by autograd: the gradient of the feature table
    that every shard reads is summed over the shards. xla_rounding as for
    tiled.march_tile_chunk."""
    check_tiled_supported(config)
    if pair_capacity is None:
        pair_capacity = tiled.default_pair_capacity(scene.num_gaussians)
    n = mesh.shape[RAY_AXIS]
    table, binning, dirs_t, valid = tiled.prepare_frame(scene, camera, config, pair_capacity)
    T = dirs_t.shape[0]
    T_local = -(-T // n)
    cand = _pad_leading(binning.cand, n * T_local, -1)
    dirs_t = _pad_leading(dirs_t, n * T_local)
    parts = []
    for _, i, dev in _local_rays(mesh):
        sl = slice(i * T_local, (i + 1) * T_local)
        chunk = (tiled.default_tile_chunk(dev, config.rays_per_tile) if tile_chunk is None
                 else tile_chunk)
        parts.append(tiled.march_frame(cand[sl].to(dev), dirs_t[sl].to(dev), camera.eye.to(dev),
                                       table.to(dev), config, chunk, xla_rounding=xla_rounding))
    rgb_t = _gather_rays(mesh, [p[0] for p in parts])[:T]
    alpha_t = _gather_rays(mesh, [p[1] for p in parts])[:T]
    return _frame(rgb_t.to(torch.float32), None, valid, camera, config,
                  alpha_t=alpha_t.to(torch.float32))


def combine_slab_segments(rgb_slabs: torch.Tensor, t_slabs: torch.Tensor):
    """Ordered front-to-back fold of per-slab (radiance, transmittance):
    rgb_slabs (S, ..., 3) composited with carry-in 1, t_slabs (S, ...)
    final transmittance. C += (product of the earlier T) * C_i is exact
    because radiance is linear in the carry-in transmittance."""
    t_excl = torch.cat([torch.ones_like(t_slabs[:1]), torch.cumprod(t_slabs, 0)[:-1]])
    return torch.sum(t_excl[..., None] * rgb_slabs, dim=0), torch.prod(t_slabs, dim=0)


def _view_depth(scene: GaussianScene, camera: Camera):
    """(unit view axis w_hat (3,), each gaussian's view depth (N,))."""
    W = camera.uvw_frame()[2]
    w_hat = W / torch.clamp(torch.linalg.vector_norm(W), min=1e-12)
    return w_hat, (scene.means - camera.eye) @ w_hat


def _slab_sorted_scene(scene: GaussianScene, camera: Camera, n: int) -> GaussianScene:
    """Contiguous view-depth slabs: the scene argsorted by view depth and
    padded to a multiple of n with copies of its last gaussian at opacity
    0 (invisible anywhere)."""
    N = scene.num_gaussians
    order = torch.argsort(_view_depth(scene, camera)[1], stable=True)
    order = _pad_leading(order, -(-N // n) * n, order[-1])
    sorted_ = {k: getattr(scene, k)[order] for k in _FIELDS}
    live = torch.arange(order.shape[0], device=order.device) < N
    sorted_["opacities"] = torch.where(live, sorted_["opacities"], 0.0)
    return GaussianScene(**sorted_, num_active=scene.num_active)


def _slab(scene: GaussianScene, k: int, n: int, device) -> GaussianScene:
    """Slab k of n of a slab-sorted scene, on `device`."""
    m = scene.num_gaussians // n
    return GaussianScene(**{f: getattr(scene, f)[k * m:(k + 1) * m].to(device) for f in _FIELDS},
                         num_active=m)


def render_gaussian_sharded(scene: GaussianScene, camera: Camera, config: RenderConfig,
                            mesh: Mesh, ray_chunk: int = 1024):
    """Full-frame render with gaussians depth-slab sharded over 'gauss'
    (and rays over 'rays' when the mesh has that axis): each shard renders
    its slab with the exact oracle (each ray's exact entry-depth order
    within the slab), and the slabs fold front to back by view depth."""
    n_slab = mesh.shape[GAUSS_AXIS]
    n_ray = mesh.shape.get(RAY_AXIS, 1)
    sorted_scene = _slab_sorted_scene(scene, camera, n_slab)
    origins, dirs, valid = generate_rays(camera, config)
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    R = o.shape[0]
    size = -(-R // (n_ray * ray_chunk)) * n_ray * ray_chunk
    o, d = _pad_leading(o, size), _pad_leading(d, size)
    per = size // n_ray
    rgb_l, t_l = [], []
    for s, i, dev in _local_rays(mesh):
        slab = _slab(sorted_scene, mesh.index(s, GAUSS_AXIS), n_slab, dev)
        rgb, _, t = render_rays_oracle(slab, o[i * per:(i + 1) * per].to(dev),
                                       d[i * per:(i + 1) * per].to(dev), config,
                                       ray_chunk=ray_chunk)
        rgb_l.append(rgb)
        t_l.append(t)
    folded = [combine_slab_segments(a, b) for a, b in
              zip(all_gather(mesh, rgb_l, GAUSS_AXIS), all_gather(mesh, t_l, GAUSS_AXIS))]
    rgb = _gather_rays(mesh, [f[0] for f in folded])[:R]
    density = 1.0 - _gather_rays(mesh, [f[1] for f in folded])[:R]
    return frame_from_rays(rgb.to(valid.device), density.to(valid.device), valid)


def render_pallas_sharded(scene: GaussianScene, camera: Camera, config: RenderConfig,
                          mesh: Mesh, pair_capacity: int | None = None,
                          chunk: int | None = None) -> dict:
    """The production forward (models/gpu_renderer.render_gpu: quad
    response, shared eye, window or key order) with image tiles sharded
    over 'rays' by bands of tile rows. The O(N) prep runs once: feature
    table, footprints, the central-ray depth key. Each shard bins only its
    band (ops/tiles.bin_pairs tile_rows=, K2 inside), gathers its own pair
    rows and marches them (K1), so the pair expansion, the tile sort, the
    row gather and the march all scale 1/n. A band's stream is the full
    stream's rows of its tiles in the same stable depth order, so the
    frame equals render_gpu's bit for bit. The bands bin without the
    scene's geometry, as JAX's do (its sharded.py:307-310), so a per-pair
    config.pair_keys is not applied here: the frame is render_gpu's under
    pair_keys="gaussian". pair_capacity is a floor for
    the whole frame: each band gets ceil(pair_capacity / n), or without it
    its own snug capacity, and a band that emits more is rebuilt (never
    dropped). Returns {rgb, alpha, n_dropped} (n_dropped summed over the
    shards; 0)."""
    check_supported(config)
    check_devices(scene, camera, use_kernels=False)
    chunk = chunk_for(config) if chunk is None else chunk
    n = mesh.shape[RAY_AXIS]
    table, M, radius = tiled.feature_table(scene, config, eye=camera.eye)
    fp = project_footprints_conic(scene.means, scene.scales, scene.quats, radius,
                                  radius * torch.amax(scene.scales, dim=-1), camera, config)
    fp = fp._replace(depth=tiled.depth_key(scene, M, radius, camera.eye, config))
    rows = compact_features(table, config.sh_degree)
    _, dirs, valid = generate_rays(camera, config)
    dirs_t = tiled.tile_rays(dirs, config.tile_w, config.tile_h)
    tx_n, ty_n = num_tiles(camera, config)
    T = tx_n * ty_n
    rows_local = -(-ty_n // n)
    T_local = rows_local * tx_n
    dirs_t = _pad_leading(dirs_t, n * T_local)
    rgb_l, t_l, dropped = [], [], []
    for _, i, dev in _local_rays(mesh):
        band = (i * rows_local, rows_local)
        fp_l = fp.to(dev)
        cap = (-(-pair_capacity // n) if pair_capacity is not None else
               snug_pair_capacity(int(footprint_pair_count(fp_l, camera, config, band))))
        stream, ids, _ = bin_footprints(fp_l, camera, config, cap, tile_rows=band)
        rgb, t = march(stream.starts, rows.to(dev)[ids], dirs_t[i * T_local:(i + 1) * T_local]
                       .to(dev), config, chunk)
        rgb_l.append(rgb)
        t_l.append(t)
        dropped.append(stream.n_dropped.to(torch.int64))
    out = _frame(_gather_rays(mesh, rgb_l)[:T], _gather_rays(mesh, t_l)[:T], valid, camera,
                 config)
    out["n_dropped"] = int(psum(mesh, dropped)[0])
    return out


def render_pallas_sharded_diff(scene: GaussianScene, camera: Camera, config: RenderConfig,
                               mesh: Mesh, pair_capacity: int | None = None,
                               chunk: int | None = None) -> dict:
    """The differentiable ray-data-parallel render (counterpart of
    render_gpu_diff): the training pair stream is binned once, and each
    shard d marches the tiles [d T_local, (d+1) T_local) of it, its slice
    starts[d T_local : (d+1) T_local + 1] of the tile starts (padded tiles
    repeat the last start, so they are empty), with K1 and saved carries
    forward and K3 backward. K3 writes zero outside its slice's rows, so
    the shards' row gradients have disjoint supports; autograd sums them
    before the one scatter-add of the row gather. Orders other than
    window and key train as key. Returns {rgb, alpha}."""
    config = train_config(config)
    check_trainable(config)
    check_devices(scene, camera, use_kernels=False)
    chunk = chunk_for(config) if chunk is None else chunk
    n = mesh.shape[RAY_AXIS]
    stream, rows, _ = prepare_train_stream(scene, camera, config, pair_capacity)
    _, dirs, valid = generate_rays(camera, config)
    dirs_t = tiled.tile_rays(dirs, config.tile_w, config.tile_h)
    T = dirs_t.shape[0]
    T_local = -(-T // n)
    dirs_t = _pad_leading(dirs_t, n * T_local)
    starts = _pad_leading(stream.starts, n * T_local + 1, stream.starts[T])
    eye = camera.eye.to(torch.float32)
    rgb_l, t_l = [], []
    for _, i, dev in _local_rays(mesh):
        rgb, t = march_stream_diff(rows.to(dev), starts[i * T_local:(i + 1) * T_local + 1].to(dev),
                                   dirs_t[i * T_local:(i + 1) * T_local].to(dev), eye.to(dev),
                                   config, chunk)
        rgb_l.append(rgb)
        t_l.append(t)
    return _frame(_gather_rays(mesh, rgb_l)[:T], _gather_rays(mesh, t_l)[:T], valid, camera,
                  config)


def render_gaussian_sharded_fast(scene: GaussianScene, camera: Camera, config: RenderConfig,
                                 mesh: Mesh, pair_capacity: int | None = None,
                                 tile_chunk: int | None = None, straddle: str = "slab",
                                 overlap_capacity: int | None = None) -> dict:
    """Depth-slab gaussian sharding on the tiled march: each shard bins and
    marches its own slab over all tiles, then the slabs fold front to back.

    straddle="slab": a gaussian straddling a slab cut composites in slab
    order. straddle="exact": every gaussian within its own bound radius of
    a cut is also placed in the neighbouring slab (overlap windows of
    overlap_capacity extra slots each side, default slab / 2), and each
    hit event composites in exactly the one slab whose view-depth interval
    [c_k, c_{k+1}) holds the event's view depth (tiled.march_frame
    depth_gate), so the fold is exactly per-ray ordered. Returns {rgb,
    alpha, n_straddle_dropped} (overlap-capacity overflow; 0 means the
    decomposition is exact)."""
    check_tiled_supported(config)
    n_slab = mesh.shape[GAUSS_AXIS]
    N = scene.num_gaussians
    w_hat, depth = _view_depth(scene, camera)
    order = torch.argsort(depth, stable=True)
    n_pad = -(-N // n_slab) * n_slab
    order = _pad_leading(order, n_pad, order[-1])
    slab = n_pad // n_slab
    dev0 = scene.device
    if straddle == "exact":
        if overlap_capacity is None:
            overlap_capacity = max(64, slab // 2)
        m_cap = slab + 2 * overlap_capacity
        if pair_capacity is None:
            pair_capacity = tiled.default_pair_capacity(m_cap)
        depth_sorted = depth[order]
        active = torch.arange(n_pad, device=dev0) < N
        op_sorted = torch.where(active, scene.opacities[order], 0.0)
        bound_r = adaptive_radius(op_sorted, config.alpha_min) * torch.amax(
            scene.scales[order], dim=-1)
        bound_r = torch.where(active, bound_r, 0.0)
        # slab k owns the view depths [lo[k], hi[k])
        cuts = depth_sorted[torch.arange(1, n_slab, device=dev0) * slab]
        inf = torch.full((1,), float("inf"), device=dev0)
        lo_bound, hi_bound = torch.cat([-inf, cuts]), torch.cat([cuts, inf])
        # members: depth + r >= c_k and depth - r < c_{k+1}, covered by the
        # contiguous windows of the prefix max of depth + r and the suffix
        # min of depth - r (one global r_max would let a single large
        # gaussian widen every window to the whole scene)
        reach_hi = torch.cummax(depth_sorted + bound_r, 0).values
        reach_lo = -torch.flip(torch.cummax(torch.flip(bound_r - depth_sorted, [0]), 0).values,
                               [0])
        lo_idx = torch.searchsorted(reach_hi, lo_bound, side="left")
        hi_idx = torch.searchsorted(reach_lo, hi_bound, side="left")
        ks = torch.arange(n_slab, device=dev0)
        # the capacity clamp keeps the owned slab [k slab, (k+1) slab) whole
        start = torch.minimum(torch.maximum(lo_idx, torch.clamp((ks + 1) * slab - m_cap, min=0)),
                              ks * slab)
        n_dropped = torch.sum(torch.clamp(start - lo_idx, min=0)
                              + torch.clamp(hi_idx - (start + m_cap), min=0))
        idx = start[:, None] + torch.arange(m_cap, device=dev0)[None, :]
        idx_c = torch.clamp(idx, 0, n_pad - 1)
        d_g, r_g = depth_sorted[idx_c], bound_r[idx_c]
        member = ((idx < n_pad) & active[idx_c] & (d_g + r_g >= lo_bound[:, None])
                  & (d_g - r_g < hi_bound[:, None]))
        g = order[idx_c]  # (n_slab, m_cap) gaussian ids
        parts = {f: getattr(scene, f)[g] for f in _FIELDS}
        parts["opacities"] = torch.where(member, parts["opacities"], 0.0)

        def slab_scene(k, dev):
            return GaussianScene(**{f: parts[f][k].to(dev) for f in _FIELDS}, num_active=m_cap)

        def gate(k, dev):
            return (w_hat.to(dev), lo_bound[k].to(dev), hi_bound[k].to(dev))
    elif straddle == "slab":
        if pair_capacity is None:
            pair_capacity = tiled.default_pair_capacity(slab)
        n_dropped = torch.zeros((), dtype=torch.int64, device=dev0)
        sorted_scene = _slab_sorted_scene(scene, camera, n_slab)

        def slab_scene(k, dev):
            return _slab(sorted_scene, k, n_slab, dev)

        def gate(k, dev):
            return None
    else:
        raise ValueError(f"unknown straddle mode {straddle!r}")

    rgb_l, t_l = [], []
    valid = None
    for s in mesh.local:
        dev, k = mesh.device(s), mesh.index(s, GAUSS_AXIS)
        table, binning, dirs_t, valid = tiled.prepare_frame(slab_scene(k, dev),
                                                            _camera_on(camera, dev), config,
                                                            pair_capacity)
        chunk = (tiled.default_tile_chunk(dev, config.rays_per_tile) if tile_chunk is None
                 else tile_chunk)
        rgb_t, alpha_t = tiled.march_frame(binning.cand, dirs_t, camera.eye.to(dev), table,
                                           config, chunk, depth_gate=gate(k, dev))
        rgb_l.append(rgb_t)
        t_l.append(1.0 - alpha_t)
    rgb_t, t_total = combine_slab_segments(all_gather(mesh, rgb_l, GAUSS_AXIS)[0],
                                           all_gather(mesh, t_l, GAUSS_AXIS)[0])
    out = _frame(rgb_t, t_total, valid, camera, config)
    out["n_straddle_dropped"] = int(n_dropped)
    return out


def _camera_on(camera: Camera, device) -> Camera:
    """The camera with its tensors on `device`."""
    if camera.device == torch.device(device):
        return camera
    return Camera(eye=camera.eye.to(device), lookat=camera.lookat.to(device),
                  up=camera.up.to(device), fov_y_deg=camera.fov_y_deg, width=camera.width,
                  height=camera.height)


def _ring(mesh: Mesh, blocks: list, march_block) -> tuple:
    """Ring exchange over 'gauss' (device s owns slab s and ray block s):
    for n rounds each shard marches its resident block against its slab,
    folds the (radiance, transmittance) segment into the block's carried
    partials, and passes the block and its partials one step around the
    ring. Block b visits slabs b, ..., n-1, 0, ..., b-1, so it carries a
    'back' partial (slabs >= b) and a 'front' one (the wrapped slabs < b),
    each folded in depth order and combined once at the end.
    march_block(shard, block id, block) -> (rgb, transmittance) of the
    block on that shard's slab. Returns each local shard's own block's
    (rgb, transmittance), home after n rounds."""
    n = mesh.shape[GAUSS_AXIS]
    perm = [(i, (i + 1) % n) for i in range(n)]
    carry = [[blk, torch.zeros((*blk.shape[:2], 3), dtype=torch.float32, device=blk.device),
              torch.ones(blk.shape[:2], dtype=torch.float32, device=blk.device),
              torch.zeros((*blk.shape[:2], 3), dtype=torch.float32, device=blk.device),
              torch.ones(blk.shape[:2], dtype=torch.float32, device=blk.device)]
             for blk in blocks]
    for k in range(n):
        for s, c in zip(mesh.local, carry):
            i = mesh.index(s, GAUSS_AXIS)
            b = (i - k) % n  # the block resident on this shard
            rgb, t = march_block(s, b, c[0])
            if i >= b:  # this slab folds into the back partial
                c[3], c[4] = c[3] + c[4][..., None] * rgb, c[4] * t
            else:
                c[1], c[2] = c[1] + c[2][..., None] * rgb, c[2] * t
        moved = [ppermute(mesh, [c[j] for c in carry], perm, GAUSS_AXIS) for j in range(5)]
        carry = [list(x) for x in zip(*moved)]
    # depth order: the front segment [0, b-1], then the back one [b, n-1]
    return ([c[1] + c[2][..., None] * c[3] for c in carry], [c[2] * c[4] for c in carry])


def render_gaussian_ring(scene: GaussianScene, camera: Camera, config: RenderConfig,
                         mesh: Mesh, pair_capacity: int | None = None,
                         tile_chunk: int | None = None) -> dict:
    """Depth-slab sharding on the tiled march with the ray ring exchange
    (`_ring`): no shard ever holds all slabs' partials, only its slab and
    one block of T/n tiles. Returns {rgb, alpha}."""
    check_tiled_supported(config)
    n = mesh.shape[GAUSS_AXIS]
    if pair_capacity is None:
        pair_capacity = tiled.default_pair_capacity(-(-scene.num_gaussians // n))
    sorted_scene = _slab_sorted_scene(scene, camera, n)
    _, dirs, valid = generate_rays(camera, config)
    dirs_all = tiled.tile_rays(dirs, config.tile_w, config.tile_h)
    T = dirs_all.shape[0]
    T_local = -(-T // n)
    dirs_all = _pad_leading(dirs_all, n * T_local)
    frames = {}
    for s in mesh.local:  # bin each slab over all tiles once
        dev = mesh.device(s)
        table, binning, _, _ = tiled.prepare_frame(
            _slab(sorted_scene, mesh.index(s, GAUSS_AXIS), n, dev), _camera_on(camera, dev),
            config, pair_capacity)
        frames[s] = (table, _pad_leading(binning.cand, n * T_local, -1), dev)

    def march_block(s, b, blk):
        table, cand, dev = frames[s]
        chunk = (tiled.default_tile_chunk(dev, config.rays_per_tile) if tile_chunk is None
                 else tile_chunk)
        rgb, alpha = tiled.march_frame(cand[b * T_local:(b + 1) * T_local], blk,
                                       camera.eye.to(dev), table, config, chunk)
        return rgb.to(torch.float32), 1.0 - alpha.to(torch.float32)

    blocks = [dirs_all[mesh.index(s, GAUSS_AXIS) * T_local:][:T_local].to(mesh.device(s))
              for s in mesh.local]
    rgb_l, t_l = _ring(mesh, blocks, march_block)
    rgb_t = _gather_blocks(mesh, rgb_l)[:T]
    return _frame(rgb_t, _gather_blocks(mesh, t_l)[:T], valid, camera, config)


def _gather_blocks(mesh: Mesh, parts: list) -> torch.Tensor:
    """Tile blocks sharded over 'gauss' (block s on shard s), concatenated."""
    whole = all_gather(mesh, parts, GAUSS_AXIS)[0]
    return whole.reshape(-1, *whole.shape[2:])


def render_pallas_slabs(scene: GaussianScene, camera: Camera, config: RenderConfig,
                        mesh: Mesh, pair_capacity: int | None = None, chunk: int | None = None,
                        comm: str = "ring") -> dict:
    """Depth-slab gaussian sharding on the production kernels: shard d owns
    view-depth slab d and runs the whole kernel pipeline over it (feature
    table, footprints, binning with K2, row gather and K1 on the quad
    response from the shared eye), all 1/n sized; only the O(N) depth
    argsort that defines the slabs is shared.

    comm="gather": each shard marches every tile against its slab, then
    one all_gather and the ordered fold (combine_slab_segments).
    comm="ring": the ray ring exchange (`_ring`): each round marches the
    resident block of T/n tiles against the slab's pair-stream segments of
    those tiles; against "gather" only the final front * back regrouping
    differs (~1 ulp).

    pair_capacity is each slab's floor (prepare_pair_stream: never
    dropped). Returns {rgb, alpha, n_dropped, pairs_max_shard (the largest
    slab's pair count), n_pairs (summed)}."""
    check_supported(config)
    if comm not in ("ring", "gather"):
        raise ValueError(f"unknown comm {comm!r}")
    chunk = chunk_for(config) if chunk is None else chunk
    n = mesh.shape[GAUSS_AXIS]
    if pair_capacity is None:
        pair_capacity = tiled.default_pair_capacity(-(-scene.num_gaussians // n))
    sorted_scene = _slab_sorted_scene(scene, camera, n)
    _, dirs, valid = generate_rays(camera, config)
    dirs_all = tiled.tile_rays(dirs, config.tile_w, config.tile_h)
    T = dirs_all.shape[0]
    T_local = -(-T // n)
    dirs_all = _pad_leading(dirs_all, n * T_local)
    streams, n_pairs, dropped = {}, [], []
    for s in mesh.local:
        dev = mesh.device(s)
        stream, feats, pairs = prepare_pair_stream(
            _slab(sorted_scene, mesh.index(s, GAUSS_AXIS), n, dev), _camera_on(camera, dev),
            config, pair_capacity)
        # padded tiles repeat the last start: K1 sees them empty
        streams[s] = (_pad_leading(stream.starts, n * T_local + 1, stream.starts[T]), feats)
        n_pairs.append(torch.tensor(pairs, dtype=torch.int64, device=dev))
        dropped.append(stream.n_dropped.to(torch.int64))
    if comm == "gather":
        rgb_l, t_l = [], []
        for s in mesh.local:
            starts, feats = streams[s]
            rgb, t = march(starts, feats, dirs_all.to(mesh.device(s)), config, chunk)
            rgb_l.append(rgb)
            t_l.append(t)
        rgb_t, t_total = combine_slab_segments(all_gather(mesh, rgb_l, GAUSS_AXIS)[0],
                                               all_gather(mesh, t_l, GAUSS_AXIS)[0])
    else:
        def march_block(s, b, blk):
            starts, feats = streams[s]
            return march(starts[b * T_local:(b + 1) * T_local + 1], feats, blk, config, chunk)

        blocks = [dirs_all[mesh.index(s, GAUSS_AXIS) * T_local:][:T_local].to(mesh.device(s))
                  for s in mesh.local]
        rgb_l, t_l = _ring(mesh, blocks, march_block)
        rgb_t, t_total = _gather_blocks(mesh, rgb_l), _gather_blocks(mesh, t_l)
    out = _frame(rgb_t[:T], t_total[:T], valid, camera, config)
    out.update(n_dropped=int(psum(mesh, dropped, GAUSS_AXIS)[0]), pairs_max_shard=int(pmax(mesh, n_pairs, GAUSS_AXIS)[0]),
               n_pairs=int(psum(mesh, n_pairs, GAUSS_AXIS)[0]))
    return out
