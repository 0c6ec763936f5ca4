"""Gaussian particle scene as a structure of tensors (counterpart of
gaussian_ray_tracing_tpu/scene/gaussians.py).

Activated parameters (scale = exp(raw), unit wxyz quaternion, opacity =
sigmoid(raw)), padded to a multiple of PAD_MULTIPLE like the JAX scene.
The padding is part of the render: padding gaussians still emit pairs
through the +-1 px footprint rect, and those pairs move chunk boundaries
in the march, so the port pads exactly as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAD_MULTIPLE = 256
_FIELDS = ("means", "scales", "quats", "opacities", "sh")


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    """Activated gaussian parameters.

    means (N, 3), scales (N, 3), quats (N, 4) unit wxyz, opacities (N,),
    sh (N, K, 3) with DC first. Entries at index >= num_active are padding:
    unit quaternion, scale 1, opacity 0 (culled by every renderer).
    """

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor
    num_active: int = 0

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_coeffs(self) -> int:
        return self.sh.shape[1]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def center(self) -> torch.Tensor:
        """Mean of the active positions."""
        n = max(self.num_active, 1)
        return torch.sum(self.means[: self.num_active], dim=0) / n

    def to(self, device) -> "GaussianScene":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _FIELDS}
        )

    @staticmethod
    def from_activated(means, scales, quats, opacities, sh, pad_to: int | None = None,
                       device="cpu") -> "GaussianScene":
        """Build a scene from activated arrays, padding to PAD_MULTIPLE."""
        n = int(np.shape(means)[0])
        if pad_to is None:
            pad_to = -(-n // PAD_MULTIPLE) * PAD_MULTIPLE
        if pad_to < n:
            raise ValueError(f"pad_to={pad_to} < num gaussians {n}")

        def _pad(x, fill=0.0):
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            out = torch.full((pad_to,) + tuple(x.shape[1:]), fill,
                             dtype=torch.float32, device=device)
            out[:n] = x
            return out

        quats_p = _pad(quats)
        quats_p[n:, 0] = 1.0  # padding quaternions stay unit-norm
        return GaussianScene(
            means=_pad(means),
            scales=_pad(scales, 1.0),  # no 1/0 in padding canonical frames
            quats=quats_p,
            opacities=_pad(opacities),
            sh=_pad(sh),
            num_active=n,
        )

    @staticmethod
    def from_raw(means, raw_scales, raw_quats, raw_opacities, sh, pad_to=None,
                 device="cpu") -> "GaussianScene":
        """Apply the load-time activations, then pad."""
        f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
        raw_quats = f32(raw_quats)
        norm = torch.sqrt(torch.sum(raw_quats * raw_quats, dim=-1, keepdim=True))
        return GaussianScene.from_activated(
            means=f32(means),
            scales=torch.exp(f32(raw_scales)),
            quats=raw_quats / torch.clamp(norm, min=1e-12),
            opacities=torch.sigmoid(f32(raw_opacities)),
            sh=f32(sh),
            pad_to=pad_to,
            device=device,
        )

    @staticmethod
    def from_numpy(arrays: dict, num_active: int, device="cpu") -> "GaussianScene":
        """Wrap already activated AND padded arrays as they are (no
        re-activation, so the values match bit for bit across frameworks,
        where exp and sigmoid may differ by an ulp)."""
        t = {k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
             for k in _FIELDS}
        return GaussianScene(**t, num_active=int(num_active))

    def to_numpy(self) -> dict:
        return {k: getattr(self, k).detach().cpu().numpy() for k in _FIELDS}
