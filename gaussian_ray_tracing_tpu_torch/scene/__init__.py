"""scene of the PyTorch port (mirrors gaussian_ray_tracing_tpu/scene)."""
