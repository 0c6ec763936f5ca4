"""PyTorch + CUDA port of gaussian_ray_tracing_tpu for NVIDIA Hopper (H100).

The JAX package `gaussian_ray_tracing_tpu` is the reference this port is
held against; module names mirror it so each counterpart is easy to find.
This package imports torch only, never jax (importing anything under
`gaussian_ray_tracing_tpu` runs `import jax`).

Ported so far: the primary pinhole render in window order with the quad
response, a shared ray origin and SH degree 0 (models/gpu_renderer.py),
carried by two hand-written CUDA kernels built from csrc/ at first use:
the fused march (ops/march.py, csrc/march.cu) and the multi-channel int32
scan of the binning (ops/scan.py, csrc/scan.cu).
"""

import torch

# The quad response sums terms of magnitude |Q||rel||d| that cancel by
# several orders of magnitude (see ops/march.py): TF32 inputs would destroy
# it, exactly as bf16 MXU operands did on the TPU. Keep every float32
# matmul and convolution in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
