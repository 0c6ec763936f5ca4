"""The port's serving CLI and runtime helpers: `cli orbit`, `cli warmup` and
`cli bench` on the CPU (--device cpu, tiny frames), utils/timing's
PhaseTimer and benchmark, utils/log, and that the viewer, the CLI and the
helpers import no jax and nothing of the JAX package."""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu_torch import cli
from gaussian_ray_tracing_tpu_torch.utils.image import read_png
from gaussian_ray_tracing_tpu_torch.utils.log import get_logger, log_metrics
from gaussian_ray_tracing_tpu_torch.utils.timing import PhaseTimer, benchmark, profiler_trace

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "1500", "--width", "32", "--height", "24", "--device", "cpu"]
BENCH_KEYS = ("metric", "value", "unit", "mean_ms", "backend")  # the JAX bench's keys


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_orbit_writes_frames(tmp_path, capsys):
    out = tmp_path / "orbit"
    cli.main(["orbit", *SMALL, "--frames", "2", "-o", str(out)])
    names = sorted(os.listdir(out))
    assert names == ["frame_0000.png", "frame_0001.png"]
    frames = [read_png(str(out / n)) for n in names]
    assert all(f.shape == (24, 32, 3) and f.max() > 0 for f in frames)
    assert (frames[0] != frames[1]).any()  # the turntable moved
    assert "wrote 2 frames" in capsys.readouterr().out


def test_warmup_prints_variants(capsys):
    cli.main(["warmup", *SMALL])
    lines = _json_lines(capsys.readouterr().out)
    assert [ln["config"] for ln in lines[:3]] == ["pinhole", "pinhole key", "fisheye"]
    assert all(ln["pair_capacity"] > 0 and ln["seconds"] >= 0 for ln in lines[:3])
    assert lines[3] == {"warmed": 3, "method": "plain", "width": 32, "height": 24,
                        "device": "cpu", "build_seconds": None}


def test_bench_prints_jax_keys(capsys):
    cli.main(["bench", *SMALL, "--iters", "2", "--hit-multiplicity", "1"])
    (line,) = _json_lines(capsys.readouterr().out)
    assert all(k in line for k in BENCH_KEYS)
    assert line["unit"] == "Mrays/s" and line["backend"] == "cpu" and line["device"] == "cpu"
    assert line["mean_ms"] > 0 and line["frames"] == 2 and line["timer"] == "host_clock"


def test_new_commands_refuse_cuda_without_a_card():
    """Without --device cpu the commands ask for CUDA, and do not fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cmd in ("orbit", "bench", "serve", "warmup"):
        with pytest.raises(RuntimeError, match="needs CUDA"):
            cli.main([cmd, "--synthetic", "100", "--width", "32", "--height", "24"])


def test_phase_timer():
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("render"):
            time.sleep(0.002)
    with pytest.raises(ValueError):
        with timer.phase("display"):
            raise ValueError("a phase that raises is still timed")
    s = timer.summary()
    assert timer.counts == {"render": 3, "display": 1}
    assert s["render"]["total_s"] >= 0.006 and s["render"]["mean_ms"] >= 2.0
    assert s["display"]["total_s"] >= 0.0


def test_benchmark_on_the_cpu():
    calls = []
    res = benchmark(lambda x: calls.append(time.sleep(0.002) or x), 1, warmup=2, iters=3,
                    device="cpu")
    assert len(calls) == 5 and res["iters"] == 3 and res["timer"] == "host_clock"
    assert res["mean_s"] >= 0.002 and res["mean_ms"] == pytest.approx(res["mean_s"] * 1e3)


def test_profiler_trace_and_log(tmp_path):
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())
    buf = io.StringIO()
    log_metrics({"loss": 0.5}, step=3, stream=buf)
    rec = json.loads(buf.getvalue())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["ts"] > 0
    assert get_logger() is get_logger("grt") and len(get_logger().handlers) == 1


def test_serving_modules_import_no_jax():
    """With jax made unimportable, the viewer, the CLI and the timing and
    log helpers import, and nothing of the JAX package is loaded."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import gaussian_ray_tracing_tpu_torch.viewer\n"
        "import gaussian_ray_tracing_tpu_torch.cli\n"
        "import gaussian_ray_tracing_tpu_torch.utils.timing\n"
        "import gaussian_ray_tracing_tpu_torch.utils.log\n"
        "from gaussian_ray_tracing_tpu_torch import cli\n"
        "cli.main(['bench', '--synthetic', '300', '--width', '16', '--height', '16',\n"
        "          '--device', 'cpu', '--iters', '2'])\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "assert not any(m == 'gaussian_ray_tracing_tpu' or m.startswith(\n"
        "    'gaussian_ray_tracing_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_grad_check_matches_the_jax_cli(capsys):
    """cli grad-check at its defaults (32x32, random_scene(64), eps 1e-3)
    prints the JAX CLI's keys and numbers: the autodiff of the tiled march
    within 1e-4 relative of jax.grad's, the finite differences within 1e-2
    (float32 losses rounded apart). Both CLIs' eps-1e-3 differences miss
    raw_quats and raw_opacities, whose steps straddle a switch of the loss."""
    from gaussian_ray_tracing_tpu import cli as jcli

    cli.main(["grad-check", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    jcli.main(["grad-check"])
    want = json.loads(capsys.readouterr().out)
    assert set(out) == {"base_loss", "grads"} and set(out["grads"]) == set(want["grads"]) == {
        "means", "log_scales", "raw_quats", "raw_opacities", "sh"}
    assert out["base_loss"] == pytest.approx(want["base_loss"], rel=1e-5)
    for field, g in out["grads"].items():
        w = want["grads"][field]
        assert g["autodiff"] == pytest.approx(w["autodiff"], rel=1e-4), field
        assert g["finite_diff"] == pytest.approx(w["finite_diff"], rel=1e-2), field


def test_grad_check_autodiff_matches_finite_differences(capsys):
    """At eps 1e-4 every field's autodiff is within the finite difference
    at the tests/test_gradients.py bar (rtol 0.05, atol 1e-4)."""
    cli.main(["grad-check", "--device", "cpu", "--eps", "1e-4"])
    out = json.loads(capsys.readouterr().out)
    for field, g in out["grads"].items():
        assert set(g) == {"autodiff", "finite_diff"} and g["autodiff"] != 0.0, field
        assert abs(g["finite_diff"] - g["autodiff"]) <= 1e-4 + 0.05 * abs(g["autodiff"]), \
            (field, g)


def test_info_reports_scene_and_native_core(capsys):
    from gaussian_ray_tracing_tpu_torch.native import bindings

    cli.main(["info", "--synthetic", "1000", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["num_gaussians"] == 1000 and out["padded"] == 1024 and out["sh_coeffs"] == 16
    assert len(out["center"]) == 3 and out["native_core"] == bindings.available()


def test_render_method_tiled_matches_plain(tmp_path):
    """cli render --method tiled writes the frame the plain kernel path
    writes, up to 8-bit quantization (window order, 32x24)."""
    frames = {}
    for method in ("tiled", "plain"):
        path = tmp_path / f"{method}.png"
        cli.main(["render", *SMALL, "--method", method, "--hit-multiplicity", "1",
                  "-o", str(path)])
        frames[method] = read_png(str(path)).astype(int)
    assert frames["tiled"].max() > 0
    assert np.abs(frames["tiled"] - frames["plain"]).max() <= 2


def test_grad_check_and_info_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        cli.main(["grad-check", "--n", "8"])
    with pytest.raises(RuntimeError, match="needs CUDA"):
        cli.main(["info", "--synthetic", "100"])
