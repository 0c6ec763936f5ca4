"""Multi-process entry point (counterpart of
gaussian_ray_tracing_tpu/parallel/distributed.py) on torch.distributed.

`initialize_distributed` joins the processes into one process group
over a TCP store (gloo on the CPU, NCCL on CUDA). Every process then
builds the same global mesh (parallel/mesh.make_mesh with its own
shards' devices: shard s lives on rank s // n_local), and the sharded
renderers and the sharded trainer run unchanged: their collectives cross
ranks. Each process renders and trains with the same scene, camera and
targets; the frames come back whole in every process.

    # host 0                                   # host 1
    python -m gaussian_ray_tracing_tpu_torch.cli render --distributed \\
        --coordinator host0:8476 --num-processes 2 --process-id 0   # (id 1)

With no coordinator, the group reads torch's launcher environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.parallel.mesh import Mesh, all_gather


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None) -> None:
    """Join the process group (idempotent: a second call does nothing).
    coordinator "host:port" of rank 0's TCP store; backend defaults to
    NCCL where CUDA is available (each rank then takes the CUDA device
    LOCAL_RANK, else its rank modulo the device count), else gloo. Call it
    before any CUDA work."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    rank = -1 if process_id is None else process_id
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else max(rank, 0) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    dist.init_process_group(
        backend, init_method="env://" if coordinator is None else f"tcp://{coordinator}",
        world_size=-1 if num_processes is None else num_processes, rank=rank)


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_array(x, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """A process-local array as the mesh's global tensor, on the first
    local shard's device. axis=None: replicated, and every process passes
    the same values (the scene, the camera, small metadata). axis="rays":
    each process passes the blocks of its own shards along that axis, and
    the result is the whole array, gathered from every process."""
    x = torch.as_tensor(np.asarray(x), device=mesh.devices[0])
    if axis is None:
        return x
    parts = list(x.reshape(len(mesh.local), -1, *x.shape[1:]).unbind(0))
    whole = all_gather(mesh, parts, axis)[0]
    return whole.reshape(-1, *whole.shape[2:])


def global_scene(scene, mesh: Mesh):
    """The scene replicated onto the mesh (every process passes the same
    scene): on the first local shard's device; each sharded renderer
    copies it to its shards' devices."""
    return scene.to(mesh.devices[0])


def fetch(x: torch.Tensor) -> np.ndarray:
    """The global value as a numpy array (the sharded renderers return
    whole frames in every process)."""
    return x.detach().cpu().numpy()

