"""models of the PyTorch port (mirrors gaussian_ray_tracing_tpu/models)."""
