"""Native (C++) host-runtime core with numpy fallbacks (counterpart of
gaussian_ray_tracing_tpu/native/); see bindings.py."""

from gaussian_ray_tracing_tpu_torch.native.bindings import (
    argsort_u64,
    available,
    build,
    morton3d,
    obj_load_native,
    ply_read_native,
    ply_write_native,
    ref_render_native,
)

__all__ = [
    "argsort_u64",
    "available",
    "build",
    "morton3d",
    "obj_load_native",
    "ply_read_native",
    "ply_write_native",
    "ref_render_native",
]
