"""Adaptive density control: densify, split, prune, opacity reset
(counterpart of gaussian_ray_tracing_tpu/train/density.py).

The 3DGS recipe at a STATIC capacity: dead slots hold raw opacity
DEAD_LOGIT, which activates to ~0 and is culled by binning (the adaptive
radius is 0 at opacity <= alpha_min), so they cost nothing and contribute
nothing. Births fill dead slots in index order (splits and clones ranked
by the parent's slot), every scatter has unique indices.

Two departures from the JAX version, both in how, not what: the model's
leaf tensors are updated IN PLACE under torch.no_grad(), because the
optimizer holds references to them (the JAX version returns new arrays);
and the randomness comes from a torch.Generator. `densify_and_prune_core`
takes the two (N, 3) standard-normal draws as tensors, so a test can feed
it JAX's draws and compare exactly; `densify_and_prune` draws them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gaussian_ray_tracing_tpu_torch.models.gaussian_model import ALIVE_LOGIT, GaussianModel
from gaussian_ray_tracing_tpu_torch.ops.quaternion import quat_to_rotmat

# sigmoid(-12) ~ 6e-6: far below any alpha_min; binning culls these slots.
DEAD_LOGIT = -12.0


@dataclasses.dataclass(frozen=True)
class DensityConfig:
    """Schedule and thresholds (3DGS defaults, world-space gradient variant;
    the field notes are the JAX version's)."""

    densify_from_step: int = 500
    densify_until_step: int = 15_000
    densify_every: int = 100
    opacity_reset_every: int = 3_000
    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    min_opacity: float = 5e-3
    max_scale_frac: float = 0.0
    split_shrink: float = 1.6


@dataclasses.dataclass(frozen=True)
class DensityState:
    """Per-slot gradient statistics accumulated between densify rounds."""

    grad_accum: torch.Tensor  # (N,) sum of scaled ||d loss / d mean||
    grad_count: torch.Tensor  # (N,) steps the slot was observed

    @staticmethod
    def create(n_cap: int, device="cpu") -> "DensityState":
        z = lambda: torch.zeros((n_cap,), dtype=torch.float32, device=device)
        return DensityState(grad_accum=z(), grad_count=z())

    def accumulate(self, mean_grads: torch.Tensor, camera=None,
                   means: torch.Tensor | None = None) -> "DensityState":
        """Fold one step's d(loss)/d(means) (N, 3) in; with `camera` and
        `means`, the norm is scaled by depth / focal (world -> approximate
        NDC units, so the 3DGS screen-space threshold 2e-4 transfers)."""
        g = torch.linalg.vector_norm(mean_grads, dim=-1)
        if camera is not None and means is not None:
            _, _, W = camera.uvw_frame()
            wlen = torch.linalg.vector_norm(W)
            w_hat = W / torch.clamp(wlen, min=1e-12)
            depth = torch.clamp((means - camera.eye) @ w_hat, min=1e-6)
            g = g * depth / torch.clamp(wlen, min=1e-12)
        return DensityState(grad_accum=self.grad_accum + g,
                            grad_count=self.grad_count + (g > 0.0).to(torch.float32))

    def reset(self) -> "DensityState":
        return DensityState.create(self.grad_accum.shape[0], self.grad_accum.device)


def _alive_mask(model: GaussianModel) -> torch.Tensor:
    return model.raw_opacities > ALIVE_LOGIT  # DEAD_LOGIT + 1


@torch.no_grad()
def densify_and_prune_core(model: GaussianModel, dstate: DensityState, eps: torch.Tensor,
                           eps2: torch.Tensor, cfg: DensityConfig,
                           scene_extent: float) -> torch.Tensor:
    """One densify/prune round at fixed capacity, in place on `model`, with
    the sibling draws eps and the re-seeded parents' draws eps2 ((N, 3)
    standard normals). Returns touched (N,) bool: slots created, re-seeded
    or pruned, whose optimizer moments the trainer zeroes.

    The JAX version's order of operations: prune (opacity below min_opacity,
    or max scale above max_scale_frac * extent), score = grad_accum /
    max(grad_count, 1) on the survivors, split the hot large ones (parent
    re-seeded in place with shrunk scales, sibling into a dead slot), clone
    the hot small ones into dead slots; births stop when dead slots run out.
    """
    n = model.means.shape[0]
    alive = _alive_mask(model)
    scales = torch.exp(model.log_scales)
    max_scale = torch.amax(scales, dim=-1)
    prune = torch.sigmoid(model.raw_opacities) < cfg.min_opacity
    if cfg.max_scale_frac > 0:
        prune = prune | (max_scale > cfg.max_scale_frac * scene_extent)
    # prune only live slots: dead slots trivially fail the opacity floor
    prune = prune & alive
    alive = alive & ~prune

    score = dstate.grad_accum / torch.clamp(dstate.grad_count, min=1.0)
    hot = alive & (score > cfg.grad_threshold)
    big = max_scale > cfg.percent_dense * scene_extent
    split = hot & big
    birth = hot  # split | clone

    dead_order = torch.argsort(alive.to(torch.int32), stable=True)  # dead slots first
    n_dead = int((~alive).sum())
    birth_rank = torch.cumsum(birth.to(torch.int32), 0) - 1
    has_slot = birth & (birth_rank < n_dead)
    slots = dead_order[torch.clamp(birth_rank, 0, n - 1)][has_slot]

    norm = torch.linalg.vector_norm(model.raw_quats, dim=-1, keepdim=True)
    R = quat_to_rotmat(model.raw_quats / torch.clamp(norm, min=1e-12))
    child_log_scales = model.log_scales - math.log(cfg.split_shrink)
    offset = lambda e: torch.einsum("nij,nj->ni", R, scales * e)
    b_means = torch.where(split[:, None], model.means + offset(eps), model.means)
    b_log_scales = torch.where(split[:, None], child_log_scales, model.log_scales)
    parent_split = split & has_slot
    parent_means = model.means + offset(eps2)

    means = model.means.clone()
    means[slots] = b_means[has_slot]
    means = torch.where(parent_split[:, None], parent_means, means)
    log_scales = model.log_scales.clone()
    log_scales[slots] = b_log_scales[has_slot]
    log_scales = torch.where(parent_split[:, None], child_log_scales, log_scales)
    model.raw_quats[slots] = model.raw_quats[has_slot]
    model.sh[slots] = model.sh[has_slot]
    ops = model.raw_opacities.clone()
    ops[slots] = model.raw_opacities[has_slot]
    # kill pruned slots (the pre-birth alive mask must not be applied here:
    # it would kill the births just written into dead slots)
    model.raw_opacities.copy_(torch.where(prune, DEAD_LOGIT, ops))
    model.means.copy_(means)
    model.log_scales.copy_(log_scales)

    touched = torch.zeros((n,), dtype=torch.bool, device=model.means.device)
    touched[slots] = True
    return touched | parent_split | prune


def densify_and_prune(model: GaussianModel, dstate: DensityState, generator: torch.Generator,
                      cfg: DensityConfig, scene_extent: float) -> torch.Tensor:
    """densify_and_prune_core with its two (N, 3) normal draws taken from
    `generator` (on the model's device). Returns touched (N,) bool."""
    shape, dev = model.means.shape, model.means.device
    eps = torch.randn(shape, generator=generator, device=dev)
    eps2 = torch.randn(shape, generator=generator, device=dev)
    return densify_and_prune_core(model, dstate, eps, eps2, cfg, scene_extent)


@torch.no_grad()
def reset_opacities(model: GaussianModel, ceiling: float = 0.01) -> None:
    """3DGS opacity reset, in place: every live opacity clamped to at most
    `ceiling` (the logit computed in float32, as the JAX version does)."""
    c = torch.tensor(ceiling, dtype=torch.float32, device=model.raw_opacities.device)
    logit = torch.log(c) - torch.log1p(-c)
    alive = _alive_mask(model)
    model.raw_opacities.copy_(torch.where(alive, torch.minimum(model.raw_opacities, logit),
                                          model.raw_opacities))


def alive_count(model: GaussianModel) -> int:
    return int(_alive_mask(model).sum())
