"""Trainable gaussian parameterization (counterpart of
gaussian_ray_tracing_tpu/models/gaussian_model.py).

Raw (pre-activation) parameters as leaf tensors, with the standard 3DGS
activations (exp / normalize / sigmoid) applied inside the loss, so
gradients reach the raw space the optimizers update.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

FIELDS = ("means", "log_scales", "raw_quats", "raw_opacities", "sh")
# raw opacity above which a slot counts as alive (the JAX package's
# train/density.py DEAD_LOGIT + 1)
ALIVE_LOGIT = -11.0


@dataclasses.dataclass
class GaussianModel:
    """Raw gaussian parameters: means (N, 3), log_scales (N, 3), raw_quats
    (N, 4) wxyz unnormalized, raw_opacities (N,) logits, sh (N, K, 3)."""

    means: torch.Tensor
    log_scales: torch.Tensor
    raw_quats: torch.Tensor
    raw_opacities: torch.Tensor
    sh: torch.Tensor
    num_active: int = 0

    def parameters(self) -> list[torch.Tensor]:
        return [getattr(self, k) for k in FIELDS]

    def requires_grad_(self, flag: bool = True) -> "GaussianModel":
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    def activate(self) -> GaussianScene:
        """Raw -> activated scene (differentiable)."""
        norm = torch.sqrt(torch.sum(self.raw_quats * self.raw_quats, dim=-1, keepdim=True))
        return GaussianScene(
            means=self.means,
            scales=torch.exp(self.log_scales),
            quats=self.raw_quats / torch.clamp(norm, min=1e-12),
            opacities=torch.sigmoid(self.raw_opacities),
            sh=self.sh,
            num_active=self.num_active,
        )

    @staticmethod
    def from_scene(scene: GaussianScene) -> "GaussianModel":
        """Invert the activations of an activated scene (new leaf tensors)."""
        op = torch.clamp(scene.opacities.detach(), 1e-6, 1.0 - 1e-6)
        return GaussianModel(
            means=scene.means.detach().clone(),
            log_scales=torch.log(torch.clamp(scene.scales.detach(), min=1e-12)),
            raw_quats=scene.quats.detach().clone(),
            raw_opacities=torch.log(op) - torch.log1p(-op),
            sh=scene.sh.detach().clone(),
            num_active=scene.num_active,
        )

    @staticmethod
    def from_numpy(arrays: dict, num_active: int, device="cpu") -> "GaussianModel":
        """Raw parameters from numpy arrays, copied bit for bit."""
        t = {k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
             for k in FIELDS}
        return GaussianModel(**t, num_active=int(num_active))

    def to_numpy(self) -> dict:
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}

    def to_ply(self, path: str) -> None:
        """Write the raw parameters as a standard 3DGS PLY: the first
        num_active slots and every slot alive beyond them."""
        from gaussian_ray_tracing_tpu_torch.scene.ply import save_ply

        arrays = self.to_numpy()
        n = self.num_active or arrays["means"].shape[0]
        keep = arrays["raw_opacities"] > ALIVE_LOGIT
        keep[:n] = True
        save_ply(path, *(arrays[k][keep] for k in FIELDS))

    @staticmethod
    def from_ply(path: str, pad_to: int | None = None, device="cpu") -> "GaussianModel":
        from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply

        return GaussianModel.from_scene(load_ply(path, pad_to=pad_to, device=device))
