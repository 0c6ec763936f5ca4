"""The port's multi-process layer (parallel/distributed.py): two spawned
processes x 4 CPU shards over gloo form one 8-shard mesh and run the same
sharded code as this process does with 8 shards (the counterpart of
tests/test_distributed.py). Bars: the frames bit for bit (the collectives
reduce in shard order, so the two runs compute the same sums); the train
step at the sharded-step bars (loss rtol 1e-4, means atol 1e-4), since the
gradients are summed across the ranks with all_reduce."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gaussian_model import GaussianModel
from gaussian_ray_tracing_tpu_torch.parallel import distributed
from gaussian_ray_tracing_tpu_torch.parallel import mesh as pmesh
from gaussian_ray_tracing_tpu_torch.parallel import sharded as S
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_distributed_worker.py")


def run_all(make_mesh, place) -> dict:
    """The sharded frames and one train step, on meshes from make_mesh(axis)
    with the scene placed by place(scene, mesh): 64x64 / 500 gaussians of
    seed 2 (test_distributed.py's scene and camera), key order."""
    ray_mesh = make_mesh(pmesh.RAY_AXIS)
    scene = place(random_scene(500, seed=2), ray_mesh)
    cam = Camera.create(eye=(0.0, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=64, height=64)
    cfg = RenderConfig(hit_multiplicity=1, order="key")
    out = {"tiled": S.render_tiled_sharded(scene, cam, cfg, ray_mesh, pair_capacity=40_000)["rgb"]}
    p = S.render_pallas_sharded(scene, cam, cfg, ray_mesh, pair_capacity=40_000)
    out["pallas"], out["pallas_dropped"] = p["rgb"], torch.tensor(p["n_dropped"])
    ring = S.render_pallas_slabs(scene, cam, cfg.replace(order="window"),
                                 make_mesh(pmesh.GAUSS_AXIS), comm="ring")
    out["ring"], out["ring_pairs"] = ring["rgb"], torch.tensor(ring["n_pairs"])
    trainer = ttrainer.Trainer(GaussianModel.from_scene(scene), cfg, lr=1e-2, mesh=ray_mesh)
    target = torch.full((64, 64, 3), 0.3)
    out["loss"] = trainer.step_fn(trainer.model, cam, target)["loss"]
    out["means"] = trainer.model.means.detach()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    port = _free_port()
    out = tmp_path_factory.mktemp("dist") / "out.npz"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "RANK",
                                                                   "WORLD_SIZE"))}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.dirname(_WORKER)])
    procs = [subprocess.Popen([sys.executable, _WORKER, str(pid), str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    got = dict(np.load(out))
    want = run_all(lambda axis: pmesh.make_mesh(8, axis=axis, devices=["cpu"] * 8),
                   lambda scene, mesh: scene)
    return got, {k: v.detach().numpy() for k, v in want.items()}


@pytest.mark.parametrize("what", ["tiled", "pallas", "ring"])
def test_two_process_frames_match_single_process(two_process, what):
    got, want = two_process
    np.testing.assert_array_equal(got[what], want[what])
    assert int(got["pallas_dropped"]) == 0 and int(got["ring_pairs"]) == int(want["ring_pairs"])


def test_two_process_train_step_matches_single_process(two_process):
    got, want = two_process
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["means"], want["means"], atol=1e-4)


def test_initialize_is_idempotent_single_process():
    import torch.distributed as dist

    port = _free_port()
    try:
        for _ in range(2):  # the second call finds the group and returns
            distributed.initialize_distributed(f"localhost:{port}", 1, 0, backend="gloo")
        assert dist.get_world_size() == 1 and not distributed.is_multiprocess()
        mesh = pmesh.make_mesh(4, devices=["cpu"] * 4)
        assert mesh.distributed and mesh.world == 1
        x = [torch.full((2,), float(s)) for s in mesh.local]
        assert torch.equal(pmesh.psum(mesh, x)[0], torch.full((2,), 6.0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_global_array_single_process_replicates():
    mesh = pmesh.make_mesh(8, devices=["cpu"] * 8)
    x = np.arange(16.0).reshape(8, 2)
    np.testing.assert_array_equal(distributed.fetch(distributed.global_array(x, mesh)), x)
    shd = distributed.global_array(x, mesh, pmesh.RAY_AXIS)
    np.testing.assert_array_equal(distributed.fetch(shd), x)
    assert distributed.global_scene(random_scene(10, seed=0), mesh).device == mesh.devices[0]


def test_cli_render_distributed_world_of_one(tmp_path):
    port = _free_port()
    png = tmp_path / "d.png"
    res = subprocess.run(
        [sys.executable, "-m", "gaussian_ray_tracing_tpu_torch.cli", "render", "--synthetic",
         "300", "--width", "32", "--height", "32", "--device", "cpu", "--distributed",
         "--coordinator", f"localhost:{port}", "--num-processes", "1", "--process-id", "0",
         "-o", str(png)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert png.stat().st_size > 0
