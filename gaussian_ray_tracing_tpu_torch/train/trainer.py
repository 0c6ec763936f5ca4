"""Train step and fitting loop (counterpart of
gaussian_ray_tracing_tpu/train/trainer.py), single device.

optax maps onto torch.optim.Adam: `default_optimizer` is Adam with eps
1e-8 (optax.adam); `gaussian_optimizer` is the 3DGS per-group recipe, one
param group per field with eps 1e-15, the means rate decayed continuously
by 0.01^(step / total_steps) (optax.exponential_decay), and updates of the
higher SH coefficients scaled by 1/20 after Adam. The step updates the
model's tensors in place, where the JAX step returns a new state.

`Trainer.fit` runs the JAX package's segments (at most 512 steps, ending
at each density event) as plain per-step loops; `steps` is the total
schedule, so a trainer that has already taken k steps runs steps - k more.
After a segment the trainer runs the density round (train/density.py) and,
with a checkpoint directory, saves. Checkpoints are torch.save files of
the raw parameters, the optimizer state and the step, one subdirectory per
step (the orbax format is TPU-side and not reproduced).

With a mesh (parallel/mesh.py, a 1-D 'rays' mesh), the render is
ray-sharded (parallel/sharded.render_pallas_sharded_diff, or
render_tiled_sharded for method="tiled") and the optimizer is ZeRO-1
(`ZeroOptimizer`, the JAX shard_opt_state_constraint): the moments of
every slot-axis parameter are split into one contiguous row block per
shard, on the shard's device, while the parameters and their gradients
stay whole. Across processes the gradients are summed over the ranks
before the update.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Optional

import torch

from gaussian_ray_tracing_tpu_torch.config import (
    RenderConfig, check_tiled_supported, check_trainable,
)
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
from gaussian_ray_tracing_tpu_torch.models.renderer import render_diff
from gaussian_ray_tracing_tpu_torch.parallel.mesh import (
    RAY_AXIS, Mesh, all_gather, sum_across_processes,
)
from gaussian_ray_tracing_tpu_torch.train.density import (
    DensityConfig, DensityState, alive_count, densify_and_prune, reset_opacities,
)
from gaussian_ray_tracing_tpu_torch.train.losses import l2_loss

_MAX_SEGMENT = 512  # steps between checkpoints, as the JAX segments


def default_optimizer(model: GaussianModel, lr: float = 2e-3) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)


class GaussianAdam(torch.optim.Adam):
    """Per-field Adam with the 3DGS learning-rate recipe: means at
    1.6e-4 * extent decayed 100x over the run, scales 5e-3, rotations
    1e-3, opacities 5e-2, SH 2.5e-3 (higher-order coefficients at 1/20)."""

    def __init__(self, model: GaussianModel, scene_extent: float = 1.0,
                 total_steps: int = 30_000, lr_scale: float = 1.0):
        self.means_lr0 = 1.6e-4 * scene_extent * lr_scale
        self.total_steps = max(total_steps, 1)
        rates = dict(means=self.means_lr0, log_scales=5e-3 * lr_scale,
                     raw_quats=1e-3 * lr_scale, raw_opacities=5e-2 * lr_scale,
                     sh=2.5e-3 * lr_scale)
        super().__init__([dict(params=[getattr(model, k)], lr=lr, name=k)
                          for k, lr in rates.items()], eps=1e-15)
        self.count = 0  # updates applied, the schedule's step

    def means_lr(self, step: int) -> float:
        """optax.exponential_decay(lr0, total_steps, 0.01) at `step`."""
        return self.means_lr0 * 0.01 ** (step / self.total_steps)

    @torch.no_grad()
    def step(self, closure=None):
        groups = {g["name"]: g for g in self.param_groups}
        groups["means"]["lr"] = self.means_lr(self.count)
        sh = groups["sh"]["params"][0]
        rest = sh[:, 1:].clone() if sh.shape[1] > 1 else None
        loss = super().step(closure)
        if rest is not None:  # the update of the higher bands, times 1/20
            sh[:, 1:] = rest + (sh[:, 1:] - rest) * (1.0 / 20.0)
        self.count += 1
        return loss

    def state_dict(self):
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count")
        super().load_state_dict(state_dict)


def gaussian_optimizer(model: GaussianModel, scene_extent: float = 1.0,
                       total_steps: int = 30_000, lr_scale: float = 1.0) -> GaussianAdam:
    return GaussianAdam(model, scene_extent, total_steps, lr_scale)


class ZeroOptimizer:
    """ZeRO-1 over a 1-D mesh of n shards: `optimizer`'s state split into
    n contiguous row blocks of the slot axis, block d on shard d's device
    (counterpart of the JAX trainer's shard_opt_state_constraint). Each
    local shard keeps a copy of the optimizer (same class, hyper-parameters
    and schedule) over its rows of every parameter; a step loads the
    current rows and their gradients, updates them there, and gathers the
    updated rows of every shard back into the whole parameters. The
    parameters' leading dims must split into n equal blocks."""

    def __init__(self, optimizer: torch.optim.Optimizer, mesh: Mesh):
        self.mesh = mesh
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.rows = self.params[0].shape[0] // mesh.size
        self._base = optimizer
        self.shards = []  # (global shard, optimizer over its rows, {param: its rows})
        for s in mesh.local:
            part = {p: p.detach()[self._rows(s)].to(mesh.device(s), copy=True)
                    for p in self.params}
            opt = object.__new__(type(optimizer))
            opt.__dict__.update(optimizer.__dict__)
            opt.param_groups = [{**g, "params": [part[p] for p in g["params"]]}
                                for g in optimizer.param_groups]
            opt.state = collections.defaultdict(dict)
            self.shards.append((s, opt, part))

    def _rows(self, shard: int) -> slice:
        return slice(shard * self.rows, (shard + 1) * self.rows)

    def zero_grad(self, set_to_none: bool = True):
        self._base.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        updated = {p: [] for p in self.params}
        for s, opt, part in self.shards:
            for p, q in part.items():
                q.copy_(p[self._rows(s)])
                q.grad = None if p.grad is None else p.grad[self._rows(s)].to(q.device)
            opt.step()
            for p, q in part.items():
                updated[p].append(q)
        for p in self.params:
            whole = all_gather(self.mesh, updated[p], RAY_AXIS)[0]
            p.copy_(whole.reshape(p.shape))

    def state_dict(self) -> dict:
        return {"shards": [opt.state_dict() for _, opt, _ in self.shards]}

    def load_state_dict(self, state_dict: dict):
        for (_, opt, _), sd in zip(self.shards, state_dict["shards"]):
            opt.load_state_dict(sd)


def reset_opt_moments(optimizer, touched: torch.Tensor) -> None:
    """Zero the rows of touched slots in every optimizer state tensor whose
    leading axis is the slot axis (Adam's exp_avg and exp_avg_sq; 3DGS
    re-initializes the moments of created or re-seeded gaussians). The 0-d
    step counts are left alone, as the JAX version skips int32 leaves. A
    ZeroOptimizer zeroes each shard's rows on its own device."""
    if isinstance(optimizer, ZeroOptimizer):
        for s, opt, part in optimizer.shards:
            dev = next(iter(part.values())).device
            reset_opt_moments(opt, touched[optimizer._rows(s)].to(dev))
        return
    n = touched.shape[0]
    with torch.no_grad():
        for state in optimizer.state.values():
            for x in state.values():
                if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == n \
                        and x.is_floating_point():
                    x[touched] = 0.0


def check_method_trainable(config: RenderConfig, method: str) -> None:
    """The tiled march trains what it renders; the other methods train
    window or key order (config.train_config)."""
    (check_tiled_supported if method == "tiled" else check_trainable)(config)


def _render_sharded_diff(scene, camera, config: RenderConfig, mesh: Mesh, method: str,
                         pair_capacity: Optional[int]) -> dict:
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import snug_pair_capacity
    from gaussian_ray_tracing_tpu_torch.ops.tiles import count_pairs
    from gaussian_ray_tracing_tpu_torch.parallel.sharded import (
        render_pallas_sharded_diff, render_tiled_sharded,
    )

    if method == "tiled":
        if pair_capacity is None:
            with torch.no_grad():
                pair_capacity = snug_pair_capacity(int(count_pairs(scene, camera, config)))
        return render_tiled_sharded(scene, camera, config, mesh, pair_capacity=pair_capacity)
    return render_pallas_sharded_diff(scene, camera, config, mesh, pair_capacity=pair_capacity)


def _check_mesh(mesh: Mesh, method: str) -> None:
    """A sharded trainer takes a 1-D 'rays' mesh; it runs the kernels of
    its shards' devices (their plain versions on CPU shards), so it takes
    method auto or tiled, or gpu on CUDA shards."""
    if mesh.axis_names != (RAY_AXIS,):
        raise ValueError(f"the sharded trainer takes a 1-D '{RAY_AXIS}' mesh, "
                         f"not {mesh.axis_names}")
    if method not in ("auto", "gpu", "tiled"):
        raise ValueError(f"a mesh trains with method auto, gpu or tiled, not {method!r}")
    if method == "gpu" and any(d.type != "cuda" for d in mesh.devices):
        raise RuntimeError("method='gpu' needs a mesh of CUDA devices")


def make_train_step(config: RenderConfig, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = l2_loss, pair_capacity: Optional[int] = None,
                    method: str = "auto", mesh: Optional[Mesh] = None):
    """Build a train step: (model, camera, target (H, W, 3)) -> metrics.

    Renders through the differentiable path (models/renderer render_diff:
    K1 with saved carries forward, the hand-written K3 backward; window or
    key order; method="tiled": torch autograd of the tiled march, the JAX
    trainer's use_pallas=False path), takes the loss and its gradient, and
    applies one optimizer
    update to the model's tensors in place. With a mesh the render is
    ray-sharded (parallel/sharded.py) and, across processes, the gradients
    are summed over the ranks before the update. Returns {"loss": the loss
    before the update (a 0-d tensor), "mean_grads": d loss / d means (N, 3)
    at the weights before the update, for the density statistics}.
    """
    check_method_trainable(config, method)
    if mesh is not None:
        _check_mesh(mesh, method)

    def train_step(model: GaussianModel, camera, target: torch.Tensor) -> dict:
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            out = render_diff(model.activate(), camera, config, method=method,
                              pair_capacity=pair_capacity)
        else:
            out = _render_sharded_diff(model.activate(), camera, config, mesh, method,
                                       pair_capacity)
        loss = loss_fn(out["rgb"], target)
        loss.backward()
        if mesh is not None:
            sum_across_processes(mesh, [p.grad for p in model.parameters()])
        optimizer.step()
        return {"loss": loss.detach(), "mean_grads": model.means.grad}

    return train_step


class Trainer:
    """Fitting loop over (camera, target) pairs with PLY and training
    checkpoints and optional 3DGS density control (train/density.py) at the
    model's static capacity: pad it above the expected final count
    (`pad_to=` in the loaders) when enabling densification. With a mesh
    (a 1-D 'rays' mesh) the steps are ray-sharded and the optimizer is
    ZeRO-1 (ZeroOptimizer) when the capacity splits evenly over the shards;
    otherwise the moments stay whole, as in the JAX trainer."""

    def __init__(self, params: GaussianModel, config: RenderConfig = RenderConfig(),
                 lr: float = 2e-3, mesh: Optional[Mesh] = None,
                 loss_fn: Optional[Callable] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 density: Optional[DensityConfig] = None, seed: int = 0,
                 method: str = "auto"):
        check_method_trainable(config, method)
        if mesh is not None:
            _check_mesh(mesh, method)
        self.model = params.requires_grad_(True)
        self.optimizer = optimizer if optimizer is not None else default_optimizer(params, lr)
        if mesh is not None and params.means.shape[0] % mesh.size == 0:
            self.optimizer = ZeroOptimizer(self.optimizer, mesh)
        self.mesh = mesh
        self.loss_fn = loss_fn if loss_fn is not None else l2_loss
        self.config = config
        self.method = method
        self.steps_done = 0
        self._pair_capacity: int | None = None
        self._build_step()
        self.density = density
        device = params.means.device
        self.dstate = DensityState.create(params.means.shape[0], device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        # robust extent: bounding-sphere radius of the initial means
        with torch.no_grad():
            center = params.means.mean(dim=0)
            self.scene_extent = float(torch.linalg.vector_norm(params.means - center,
                                                               dim=-1).max())

    def _build_step(self):
        self.step_fn = make_train_step(self.config, self.optimizer, self.loss_fn,
                                       self._pair_capacity, self.method, self.mesh)

    def _refresh_capacity(self, views):
        """Snug pair-capacity bucket (64k multiples of 1.3x the worst view's
        exact pair count); it only grows. Re-probed after every density
        round that changed the population."""
        from gaussian_ray_tracing_tpu_torch.ops.tiles import count_pairs

        with torch.no_grad():
            scene = self.model.activate()
            worst = max(int(count_pairs(scene, cam, self.config)) for cam, _ in views)
        cap = max(1 << 16, -(-int(worst * 1.3) // 65536) * 65536)
        if self._pair_capacity is None or cap > self._pair_capacity:
            self._pair_capacity = cap
            self._build_step()

    def _density_round(self, step: int) -> bool:
        """The density events due at `step` (1-indexed): a densify/prune
        round, then an opacity reset. Returns whether the population
        changed."""
        cfg = self.density
        changed = False
        in_window = cfg.densify_from_step <= step <= cfg.densify_until_step
        if in_window and step % cfg.densify_every == 0:
            touched = densify_and_prune(self.model, self.dstate, self.generator, cfg,
                                        self.scene_extent)
            reset_opt_moments(self.optimizer, touched)
            self.dstate = self.dstate.reset()
            changed = True
        if in_window and cfg.opacity_reset_every and step % cfg.opacity_reset_every == 0:
            reset_opacities(self.model)
        return changed

    def _next_event(self, cur: int, steps: int) -> int:
        """First step > cur at which a density event fires, else `steps`."""
        c = self.density
        best = steps
        if c is None:
            return best
        for p in (c.densify_every, c.opacity_reset_every):
            if not p:
                continue
            k = (cur // p + 1) * p
            if k < c.densify_from_step:
                k = -(-c.densify_from_step // p) * p
            if k <= c.densify_until_step:
                best = min(best, k)
        return best

    def fit(self, views: list, steps: int, checkpoint_dir: str | None = None) -> list[float]:
        """Run the schedule up to `steps` total steps over the views in
        turn, in segments that end at the density events and at most 512
        steps apart; after each segment with steps remaining, the density
        round and, with `checkpoint_dir`, a checkpoint. Returns the loss of
        each step taken."""
        self._refresh_capacity(views)
        losses = []
        cur = min(self.steps_done, steps)
        while cur < steps:
            n = min(self._next_event(cur, steps), steps, cur + _MAX_SEGMENT) - cur
            seg = []
            for i in range(cur, cur + n):
                cam, target = views[i % len(views)]
                metrics = self.step_fn(self.model, cam, target)
                self.steps_done += 1
                seg.append(metrics["loss"])
                if self.density is not None:
                    self.dstate = self.dstate.accumulate(metrics["mean_grads"], camera=cam,
                                                         means=self.model.means.detach())
            losses += torch.stack(seg).tolist()  # one device sync per segment
            cur += n
            if self.density is not None and cur < steps and self._density_round(cur):
                self._refresh_capacity(views)
            if checkpoint_dir is not None and cur < steps:
                self.save_checkpoint(checkpoint_dir)
        return losses

    def alive(self) -> int:
        return alive_count(self.model)

    def save(self, path: str):
        """Checkpoint the scene as a standard 3DGS PLY."""
        self.model.to_ply(path)

    def save_checkpoint(self, directory: str, step: int | None = None):
        """Training checkpoint: raw parameters, optimizer state and step,
        torch.save'd to <directory>/<step>/train_state.pt."""
        step = self.steps_done if step is None else step
        path = os.path.join(directory, str(step))
        os.makedirs(path, exist_ok=True)
        torch.save({"params": {k: getattr(self.model, k).detach() for k in FIELDS},
                    "num_active": self.model.num_active, "step": self.steps_done,
                    "optimizer": self.optimizer.state_dict()},
                   os.path.join(path, "train_state.pt"))

    def restore_checkpoint(self, directory: str, step: int | None = None):
        """Restore the newest checkpoint under `directory` (or `step`) in
        place: parameters (same capacity), optimizer state and step."""
        if step is None:
            step = max(checkpoint_steps(directory))
        state = torch.load(os.path.join(directory, str(step), "train_state.pt"),
                           map_location=self.model.means.device, weights_only=True)
        with torch.no_grad():
            for k in FIELDS:
                getattr(self.model, k).copy_(state["params"][k])
        self.model.num_active = state["num_active"]
        self.optimizer.load_state_dict(state["optimizer"])
        self.steps_done = int(state["step"])


def checkpoint_steps(directory: str) -> list[int]:
    """Steps of the checkpoints saved under `directory` (empty if none)."""
    if not os.path.isdir(directory):
        return []
    return [int(d) for d in os.listdir(directory)
            if d.isdigit() and os.path.isfile(os.path.join(directory, d, "train_state.pt"))]
