"""Tracing and timing on the card, counterpart of
`rga3_tpu/utils/profiling.py`:

  * `trace(profile_dir)` records a `torch.profiler` trace (the host, and
    the card's kernels where there is a card) of the region it wraps and
    writes it into the directory as a Chrome trace (`*.pt.trace.json`,
    readable in Perfetto or chrome://tracing); a no-op for None;
  * `annotate(name)` names a region inside a trace (`record_function`);
  * `device_timeit` times a call on the card with CUDA events;
  * `StepTimer` keeps a rolling window of step times;
  * `peak_flops_per_chip` is the card's dense bf16 peak, from its name:
    989 TFLOP/s for an H100 SXM (NVIDIA's data sheet, at 700 W), the rate
    the port's bounds use. Any other card raises: there is no default;
  * `mfu` is model FLOPs over seconds over that peak.

The JAX package's `compiled_flops` reads XLA's cost model, which PyTorch
has no counterpart of: the port counts model FLOPs analytically
(`utils.flops`).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

# dense bf16 tensor-core peak by the name `torch.cuda.get_device_name` gives
_PEAK_BF16_FLOPS = {
    "H100 80GB HBM3": 989e12,
    "H100 SXM": 989e12,
}


@contextlib.contextmanager
def trace(profile_dir: Optional[str], name: str = "trace") -> Iterator[None]:
    """Record a torch.profiler trace of the wrapped region into
    `profile_dir/<name>.<pid>.<ns>.pt.trace.json` (no-op when None)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


def device_timeit(fn, *args, iters: int = 50, repeats: int = 5) -> float:
    """Milliseconds per call of `fn(*args)` on the card: one warm-up call,
    then `repeats` runs of `iters` calls between two CUDA events; the best
    run. Eager PyTorch neither caches nor elides repeated calls, so the
    inputs need no perturbing (the JAX package's on-device loop does)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_timeit times the card: no CUDA device")
    fn(*args)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


class StepTimer:
    """Rolling step timing (batch_time / data_time) with percentile
    summaries."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def summary(self) -> dict:
        import numpy as np

        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / max(arr.mean(), 1e-9)),
        }


def peak_flops_per_chip(device_name: Optional[str] = None) -> float:
    """The dense bf16 peak FLOP/s of the card named `device_name` (default:
    the current CUDA device's name). Raises RuntimeError without a card and
    ValueError for a card this table does not know."""
    if device_name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("peak_flops_per_chip: no CUDA device")
        device_name = torch.cuda.get_device_name()
    for name, val in _PEAK_BF16_FLOPS.items():
        if name in device_name:
            return val
    raise ValueError(f"peak_flops_per_chip: no peak known for {device_name!r}")


def mfu(flops_per_call: float, seconds_per_call: float, peak: Optional[float] = None
        ) -> float:
    """Model FLOPs utilization against `peak` (default: the card's
    `peak_flops_per_chip`)."""
    if flops_per_call <= 0 or seconds_per_call <= 0:
        return 0.0
    return flops_per_call / seconds_per_call / (peak or peak_flops_per_chip())
