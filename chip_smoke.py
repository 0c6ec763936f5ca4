#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gaussian_ray_tracing_tpu_torch) on
one NVIDIA GPU: builds the hand-written kernels from the checkout, holds
each against its plain torch version, renders the exact-oracle goldens
through the kernel path, drives the main path (GaussianRayTracer, 1280x720,
100k gaussians, bench config) and times it against the plain path.

    python3 chip_smoke.py

Run from (a copy of) the repository. Exits non-zero, printing no result,
without CUDA or without the package beside this file. On success the last
two lines are the kernel table and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "gaussian_ray_tracing_tpu_torch"
BENCH_KW = dict(hit_multiplicity=1, order="window", march_chunk=128)
GOLDEN_EYE = (0.0, 0.3, 2.8)
PSNR_KERNEL, MAXABS_KERNEL = 70.0, 1e-2  # the JAX suite's quad-path bars
PSNR_GOLDEN = 40.0  # the exact-oracle parity bar


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call milliseconds of fn(), each bracketed by CUDA events."""
    import torch

    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def main() -> None:
    if not (ROOT / PKG / "__init__.py").is_file():
        fail(f"{PKG}/ not found beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
               f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from gaussian_ray_tracing_tpu_torch import cameras
    from gaussian_ray_tracing_tpu_torch.config import RenderConfig
    from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
    from gaussian_ray_tracing_tpu_torch.models.renderer import GaussianRayTracer, render
    from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
    from gaussian_ray_tracing_tpu_torch.ops import cuda_build
    from gaussian_ray_tracing_tpu_torch.ops import march as kmarch
    from gaussian_ray_tracing_tpu_torch.ops import scan as kscan
    from gaussian_ray_tracing_tpu_torch.scene.ply import load_ply
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
    from gaussian_ray_tracing_tpu_torch.utils.image import psnr

    # --- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load_library()
    log("build", f"{lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("ptxas", line.strip())

    # --- phase 2: K2 scan vs plain (exact) ------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    scan_err = 0
    for shape in ((2, 1_500_000), (16, 1_000_003)):
        x = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=dev,
                          generator=g)
        x[:, ::997] = 2**31 - 1  # partial sums wrap
        got = kscan.multi_cumsum_i32(x)
        want = kscan.multi_cumsum_i32_plain(x)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        scan_err = max(scan_err, err)
        check(torch.equal(got, want), f"K2 scan differs from plain at {shape}")
        log("K2", f"scan {shape} == plain (exact)")

    # --- phase 3: K1 march vs plain on identical pair streams -----------
    def golden(name):
        z = np.load(ROOT / "data" / "golden" / f"{name}.npz")
        n, seed, width, height, hm, fisheye = (int(v) for v in z["meta"])
        check(not fisheye, f"{name}: fisheye goldens are not ported yet")
        scene = random_scene(n, seed=seed, device=dev)
        cam = cameras.Camera.create(eye=GOLDEN_EYE, lookat=(0.0, 0.0, 0.0),
                                    width=width, height=height, device=dev)
        return z["rgb"].astype(np.float32), scene, cam, hm

    march_err = 0.0
    for name in ("small_pinhole_256", "pinhole_720p"):
        _, scene, cam, hm = golden(name)
        for chunk in (128, 256):
            for skip in (0.02, 1e-3):
                cfg = RenderConfig(hit_multiplicity=hm, march_chunk=chunk,
                                   chunk_skip_transmittance=skip)
                stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 16)
                dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], 16, 16)
                rgb, tf = kmarch.march(stream.starts, feats, dirs_t, cfg, chunk)
                torch.cuda.synchronize()
                rgb_p, tf_p = kmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk)
                for what, a, b in (("rgb", rgb, rgb_p), ("T_final", tf, tf_p)):
                    a, b = a.cpu().numpy(), b.cpu().numpy()
                    p, m = psnr(a, b), float(np.abs(a - b).max())
                    march_err = max(march_err, m)
                    log("K1", f"{name} c={chunk} skip={skip} {what}: "
                              f"PSNR {p:.2f} dB max abs {m:.3g}")
                    check(p >= PSNR_KERNEL and m <= MAXABS_KERNEL,
                          f"K1 vs plain {name} c={chunk} skip={skip} {what}")

    # --- phase 4: goldens through the full GPU path ---------------------
    for name in ("pinhole_720p", "hm2_720p", "small_pinhole_256", "small_hm2_256"):
        ref, scene, cam, hm = golden(name)
        cfg = RenderConfig(hit_multiplicity=hm, order="window", march_chunk=128)
        out = render(scene, cam, cfg, method="gpu", return_aux=True)
        p = psnr(out["rgb"].cpu().numpy(), ref)
        log("golden", f"{name}: PSNR {p:.2f} dB vs exact oracle, "
                      f"{out['aux']['n_pairs']} pairs")
        check(p >= PSNR_GOLDEN, f"golden {name} PSNR {p:.2f} < {PSNR_GOLDEN}")

    # --- phase 5: the main path at full size ----------------------------
    cfg = RenderConfig(**BENCH_KW)
    scene = random_scene(100_000, seed=0, device=dev)
    tracer = GaussianRayTracer(scene=scene, config=cfg)
    tracer.set_size(1280, 720)
    radius = float(np.linalg.norm(GOLDEN_EYE))
    poses = [cameras.orbit_camera((0.0, 0.0, 0.0), radius, az, 6.0, width=1280,
                                  height=720, device=dev) for az in (0, 90, 180, 270)]
    ply = load_ply(str(ROOT / "data" / "fitted_20k.ply"), device=dev)
    ply_tracer = GaussianRayTracer(scene=ply, config=cfg)
    ply_tracer.set_size(1280, 720)
    ply_cam = cameras.Camera.create(
        eye=ply.center().cpu().numpy() + np.array([0.0, 0.0, 3.0]),
        lookat=ply.center().cpu().numpy(), width=1280, height=720, device=dev,
    )
    ply_tracer.update_camera(ply_cam)

    kmarch.march.launches = 0
    kscan.multi_cumsum_i32.launches = 0
    frames = []
    for i, (tr, cam) in enumerate([(tracer, c) for c in poses] + [(ply_tracer, ply_cam)]):
        k1, k2 = kmarch.march.launches, kscan.multi_cumsum_i32.launches
        tr.update_camera(cam)
        out = tr.render()
        rgb = out["rgb"]
        torch.cuda.synchronize()
        check(kmarch.march.launches > k1 and kscan.multi_cumsum_i32.launches > k2,
              f"frame {i}: a kernel was not launched")
        check(tuple(rgb.shape) == (720, 1280, 3) and bool(torch.isfinite(rgb).all()),
              f"frame {i}: bad output {tuple(rgb.shape)}")
        check(float(rgb.max()) > 0.1, f"frame {i} is black")
        frames.append(rgb)
    launches = {"march": kmarch.march.launches, "scan": kscan.multi_cumsum_i32.launches}
    log("main", f"5 frames (4 orbit poses of 100k, fitted_20k.ply), launches {launches}")

    # drop-free stream and GPU-vs-plain agreement on the first pose
    cap = tracer._pair_capacity
    out = render(scene, poses[0], cfg, method="gpu", return_aux=True)
    check(out["aux"]["n_dropped"] == 0, "pairs dropped")
    plain0 = render(scene, poses[0], cfg, method="plain")["rgb"]
    p = psnr(out["rgb"].cpu().numpy(), plain0.cpu().numpy())
    log("main", f"100k 720p: {out['aux']['n_pairs']} pairs, n_dropped 0, bucket {cap}, "
                f"gpu vs plain PSNR {p:.2f} dB")
    check(p >= 60.0, f"gpu vs plain frame PSNR {p:.2f} < 60")

    reps = 12
    tracer.update_camera(poses[0])
    ms = {}
    for label, tr, meth in (("gpu", tracer, "gpu"), ("plain", tracer, "plain"),
                            ("ply_gpu", ply_tracer, "gpu"), ("ply_plain", ply_tracer, "plain")):
        tr.render(method=meth)  # warm-up
        ms[label] = statistics.median(cuda_ms(lambda: tr.render(method=meth), reps))
    log("frame", f"1280x720 100k bench config, median of {reps}: gpu {ms['gpu']:.3f} ms, "
                 f"plain {ms['plain']:.3f} ms ({card})")
    log("frame", f"1280x720 fitted_20k.ply, median of {reps}: gpu {ms['ply_gpu']:.3f} ms, "
                 f"plain {ms['ply_plain']:.3f} ms ({card})")

    # kernels alone at the main path's shapes (100k, 720p, first pose)
    stream, feats, n_pairs = prepare_pair_stream(scene, poses[0], cfg, cap)
    dirs_t = tile_rays(cameras.generate_rays(poses[0], cfg)[1], 16, 16)
    chunk = kmarch.chunk_for(cfg)
    k1_ms = statistics.median(cuda_ms(
        lambda: kmarch.march(stream.starts, feats, dirs_t, cfg, chunk), 20))
    k1_plain = statistics.median(cuda_ms(
        lambda: kmarch.march_plain(stream.starts, feats, dirs_t, cfg, chunk), 5))
    x = torch.randint(-1000, 1000, (2, cap), dtype=torch.int32, device=dev, generator=g)
    k2_ms = statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32(x), 50))
    k2_plain = statistics.median(cuda_ms(lambda: kscan.multi_cumsum_i32_plain(x), 50))
    log("kernel", f"K1 march {n_pairs} pairs c={chunk}: {k1_ms:.3f} ms, plain "
                  f"{k1_plain:.3f} ms; K2 scan (2, {cap}): {k2_ms:.4f} ms, plain "
                  f"{k2_plain:.4f} ms ({card})")

    # --- CLI, one frame through a user's entry point ---------------------
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        png = Path(tmp) / "cli.png"
        res = subprocess.run(
            [sys.executable, "-m", f"{PKG}.cli", "render", "--synthetic", "100000",
             "--width", "1280", "--height", "720", "-o", str(png)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        check(res.returncode == 0, f"cli render failed:\n{res.stderr[-4000:]}")
        check(png.is_file() and png.stat().st_size > 0, "cli wrote no PNG")
        img = _png_pixels(png)
        check(img.max() > 0, "cli PNG is all black")
        log("cli", f"{res.stdout.strip()} (max pixel {int(img.max())})")

    src = f"{PKG}/csrc"
    print(json.dumps({"kernels": [
        {"name": "march", "route": "cuda", "source": f"{src}/march.cu",
         "replaces": "gaussian_ray_tracing_tpu/ops/pallas_march.py:195",
         "launches": launches["march"], "max_abs_err": march_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "multi_cumsum_i32", "route": "cuda", "source": f"{src}/scan.cu",
         "replaces": "gaussian_ray_tracing_tpu/ops/scan.py:81",
         "launches": launches["scan"], "max_abs_err": scan_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _png_pixels(path: Path):
    """Decode an 8-bit RGB PNG written by utils/image.write_png."""
    import struct
    import zlib

    import numpy as np

    data = path.read_bytes()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:]  # filter type 0 (none) on every row


if __name__ == "__main__":
    main()
