"""Timing and profiling helpers (counterpart of
gaussian_ray_tracing_tpu/utils/timing.py, which replaces the reference's
std::chrono frame-phase timers and ImGui FPS overlay, src/main.cpp:84-118,
src/gui.cpp:444-491).

`benchmark` times a function on the device its result lives on: CUDA
events around the timed calls on a CUDA device (after a synchronise, so
the warm-up's work is not counted), the host clock on the CPU.
`profiler_trace` wraps a block in torch.profiler and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimer:
    """Accumulates named phase times like the reference's state / render /
    display split (main.cpp:84-118), on the host clock."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "mean_ms": 1e3 * v / max(self.counts[k], 1)}
                for k, v in self.totals.items()}


def benchmark(fn, *args, warmup: int = 2, iters: int = 10, device=None, **kw) -> dict:
    """Steady-state time of fn(*args, **kw): `warmup` untimed calls, then
    `iters` timed ones. On a CUDA `device` (default: the current CUDA
    device when CUDA is available, else the CPU) the time is CUDA events
    around the timed calls, the device synchronised before and after;
    on the CPU the host clock. Returns {mean_s, mean_ms, iters, timer}."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args, **kw)
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args, **kw)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        timer = "cuda_events"
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kw)
        dt = (time.perf_counter() - t0) / iters
        timer = "host_clock"
    return {"mean_s": dt, "mean_ms": dt * 1e3, "iters": iters, "timer": timer}


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler (CPU and, when available, CUDA activity) around a
    block; writes logdir/trace.json (chrome://tracing, Perfetto) and
    yields the profiler, whose key_averages() sums the ops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
