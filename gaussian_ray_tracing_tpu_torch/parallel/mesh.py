"""Device meshes and their collectives (counterpart of
gaussian_ray_tracing_tpu/parallel/mesh.py and of the shard_map
collectives its sharded renderers use).

JAX runs a sharded renderer as one SPMD program over a jax.sharding.Mesh
(shard_map). Here a `Mesh` is a list of shards, each placed on a
torch.device, with axis names and a shape. Several shards may share a
device: 8 shards on `cpu` for the tests, n shards on `cuda:0` on one card,
one shard per GPU on a multi-GPU host. A sharded function loops over the
shards its process holds (`Mesh.local`, in shard order) and the
collectives below combine one tensor per local shard along a mesh axis:
`all_gather`, `psum`, `pmax` and `ppermute`. They move tensors with
`.to(device)`, so autograd flows back through them; the gradient of a
tensor every shard reads is summed by autograd, which is what shard_map's
transpose does with its psum.

Across processes (parallel/distributed.py) every rank builds the same
global mesh from its own devices: shard s lives on rank s // n_local.
`all_gather`, `psum` and `pmax` then exchange every shard's tensor with
torch.distributed.all_gather_into_tensor and reduce in shard order, so a
multi-process result equals the single-process one bit for bit;
`ppermute` sends each shard's tensor to its destination's rank with
batch_isend_irecv. Tensors received from other ranks carry no autograd
history: a multi-process trainer sums the replicated parameters'
gradients across ranks (`sum_across_processes`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

RAY_AXIS = "rays"
GAUSS_AXIS = "gauss"


@dataclasses.dataclass(eq=False)
class Mesh:
    """Shards over named axes. `devices` are this process's shards'
    devices, in shard order; `sizes` the global mesh shape (row-major
    over `axis_names`); `rank` of `world` processes, and whether the
    collectives go through torch.distributed (`distributed`, also in a
    world of one)."""

    devices: list
    axis_names: tuple
    sizes: tuple
    rank: int = 0
    world: int = 1
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def local(self) -> list:
        """Global indices of the shards this process holds."""
        n = len(self.devices)
        return list(range(self.rank * n, (self.rank + 1) * n))

    def rank_of(self, shard: int) -> int:
        return shard // len(self.devices)

    def device(self, shard: int) -> torch.device:
        return self.devices[shard - self.rank * len(self.devices)]

    def index(self, shard: int, axis: str) -> int:
        """The shard's coordinate along `axis`."""
        return int(np.unravel_index(shard, self.sizes)[self.axis_names.index(axis)])

    def group(self, shard: int, axis: str) -> list:
        """The shards that share every coordinate but `axis` with `shard`,
        in order along `axis`."""
        coords = list(np.unravel_index(shard, self.sizes))
        k = self.axis_names.index(axis)
        out = []
        for i in range(self.sizes[k]):
            coords[k] = i
            out.append(int(np.ravel_multi_index(coords, self.sizes)))
        return out


def _world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


def _mesh(axis_names: tuple, sizes: tuple, devices) -> Mesh:
    rank, world, distributed = _world()
    size = math.prod(sizes)
    if size % world:
        raise ValueError(f"{size} shards do not split over {world} processes")
    n_local = size // world
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        first = torch.cuda.current_device() if have else 0
        if have - first < n_local:
            raise RuntimeError(
                f"the mesh needs {n_local} CUDA devices in this process and finds "
                f"{max(have - first, 0)}; pass devices= to place shards (several may "
                "share one device)")
        devices = [torch.device("cuda", first + i) for i in range(n_local)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_local:
        raise ValueError(f"{len(devices)} devices for {n_local} shards in this process")
    return Mesh(devices, tuple(axis_names), tuple(sizes), rank, world, distributed)


def make_mesh(n_devices: int | None = None, axis: str = RAY_AXIS, devices=None) -> Mesh:
    """1-D mesh of n shards (rays-sharded by default). `devices` places
    this process's shards (n / processes of them); without it they take
    consecutive CUDA devices from the current one, and the call raises
    if there are too few. n defaults to every CUDA device of every
    process."""
    if n_devices is None:
        n_devices = _world()[1] * (len(devices) if devices is not None
                                   else torch.cuda.device_count())
        if n_devices == 0:
            raise RuntimeError("make_mesh found no CUDA device; pass devices=")
    return _mesh((axis,), (n_devices,), devices)


def make_mesh_2d(n_ray: int, n_gauss: int, devices=None) -> Mesh:
    """(rays, gauss) mesh of n_ray x n_gauss shards, row-major."""
    return _mesh((RAY_AXIS, GAUSS_AXIS), (n_ray, n_gauss), devices)


def ray_axis_sharding(mesh: Mesh, x: torch.Tensor, axis: str = RAY_AXIS) -> list:
    """Split the leading dim of x into mesh.shape[axis] equal blocks and
    give each local shard its block on its device."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not split into {n} shards")
    blocks = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    return [blocks[mesh.index(s, axis)].to(mesh.device(s)) for s in mesh.local]


def replicated(mesh: Mesh, x: torch.Tensor) -> list:
    """x on every local shard's device."""
    return [x.to(mesh.device(s)) for s in mesh.local]


def _every_shard(mesh: Mesh, xs: list) -> dict:
    """Every shard's tensor by global index: the local ones as given, the
    others from their processes (all shards' tensors share a shape)."""
    vals = dict(zip(mesh.local, xs))
    if not mesh.distributed:
        return vals
    import torch.distributed as dist

    mine = torch.stack([x.detach().to(mesh.devices[0]) for x in xs]).contiguous()
    out = mine.new_empty((mesh.world * mine.shape[0], *mine.shape[1:]))
    dist.all_gather_into_tensor(out, mine)
    for s in range(mesh.size):
        vals.setdefault(s, out[s])
    return vals


def all_gather(mesh: Mesh, xs: list, axis: str = RAY_AXIS) -> list:
    """jax.lax.all_gather: for each local shard, the tensors of its group
    along `axis` stacked in axis order, on the shard's device."""
    vals = _every_shard(mesh, xs)
    return [torch.stack([vals[g].to(mesh.device(s)) for g in mesh.group(s, axis)])
            for s in mesh.local]


def psum(mesh: Mesh, xs: list, axis: str = RAY_AXIS) -> list:
    """jax.lax.psum over `axis`, summed in shard order."""
    return [torch.sum(a, dim=0) for a in all_gather(mesh, xs, axis)]


def pmax(mesh: Mesh, xs: list, axis: str = RAY_AXIS) -> list:
    """jax.lax.pmax over `axis`."""
    return [torch.amax(a, dim=0) for a in all_gather(mesh, xs, axis)]


def ppermute(mesh: Mesh, xs: list, perm, axis: str = RAY_AXIS) -> list:
    """jax.lax.ppermute: within each group along `axis`, the shard at index
    i sends its tensor to index j for every (i, j) in perm; a shard that
    receives nothing gets zeros. Tensors share a shape and dtype."""
    vals = dict(zip(mesh.local, xs))
    src_of = {j: i for i, j in perm}
    out = {s: torch.zeros_like(x) for s, x in vals.items()}
    p2p = []
    for dst in range(mesh.size):  # one global order of (src, dst), the same on every rank
        i = src_of.get(mesh.index(dst, axis))
        if i is None:
            continue
        src = mesh.group(dst, axis)[i]
        if src in vals and dst in vals:
            out[dst] = vals[src].to(mesh.device(dst))
        elif src in vals or dst in vals:
            import torch.distributed as dist

            if src in vals:
                p2p.append(dist.P2POp(dist.isend, vals[src].contiguous(), mesh.rank_of(dst)))
            else:
                p2p.append(dist.P2POp(dist.irecv, out[dst], mesh.rank_of(src)))
    if p2p:
        import torch.distributed as dist

        for req in dist.batch_isend_irecv(p2p):
            req.wait()
    return [out[s] for s in mesh.local]


def sum_across_processes(mesh: Mesh, tensors) -> None:
    """Sum tensors in place across the mesh's processes (all_reduce); a
    no-op in one process."""
    if not mesh.distributed:
        return
    import torch.distributed as dist

    for t in tensors:
        if t is not None:
            dist.all_reduce(t)
