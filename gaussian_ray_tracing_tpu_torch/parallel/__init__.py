"""Multi-device and multi-process rendering and training (counterpart of
gaussian_ray_tracing_tpu/parallel/): rays or tiles sharded over a mesh
(data parallel), gaussians replicated or depth-slab partitioned with an
ordered segment fold, and gradients summed over the shards.
"""

from gaussian_ray_tracing_tpu_torch.parallel.mesh import make_mesh, ray_axis_sharding
from gaussian_ray_tracing_tpu_torch.parallel.sharded import (
    render_gaussian_sharded,
    render_pallas_slabs,
    render_rays_sharded_oracle,
    render_tiled_sharded,
)

__all__ = [
    "make_mesh",
    "ray_axis_sharding",
    "render_tiled_sharded",
    "render_rays_sharded_oracle",
    "render_gaussian_sharded",
    "render_pallas_slabs",
]
