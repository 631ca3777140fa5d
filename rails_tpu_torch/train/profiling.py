"""Tracing and throughput timing.

Counterpart of `rails_tpu/train/profiling.py`:
- `trace(log_dir)` records the region under `torch.profiler` (host and, on
  a card, device activity) and writes a Chrome trace to
  `<log_dir>/trace.json`. The JAX context degrades to a no-op where its
  TPU profiler is missing; here a profiler error raises.
- `Timer(device)` times a `with` region between CUDA events on a card, the
  host clock on the CPU.
- `benchmark(fn, inputs, warmup, repeats)` calls fn over distinct inputs,
  `warmup` calls first, then `repeats` passes over every input, each pass
  one `Timer` region (one synchronise after the pass); per-call ms.
- `timed_ms(fn, runs, device, repeats)`: `benchmark` of an argument-free fn,
  one warm-up call, the best of `repeats` passes of `runs` calls. The CLIs
  and `chip_smoke.py` time through it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch


class Timer:
    """Elapsed ms of a `with` region on `device`: CUDA events on a card,
    read after one synchronise (a host clock around unsynchronised launches
    would time the launch queue), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms = float("nan")

    def __enter__(self) -> "Timer":
        if self.cuda:
            self._start, self._end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = 1e3 * (time.perf_counter() - self._t0)
        return False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body; the Chrome trace lands in `<log_dir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark(
    fn: Callable,
    inputs: Sequence,
    warmup: int = 3,
    repeats: int = 3,
    device: torch.device = torch.device("cuda"),
) -> dict:
    """Per-call ms of fn over `inputs` on `device` (best, mean and spread of
    the `repeats` passes)."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    times: List[float] = []
    for _ in range(repeats):
        with Timer(device) as timer:
            for x in inputs:
                fn(x)
        times.append(timer.ms / len(inputs))
    arr = np.asarray(times)
    return {
        "best_ms": float(arr.min()),
        "mean_ms": float(arr.mean()),
        "std_ms": float(arr.std()),
        "num_inputs": len(inputs),
        "repeats": repeats,
    }


def timed_ms(fn: Callable[[], object], runs: int, device: torch.device,
             repeats: int = 1) -> float:
    """Per-call ms of fn: one warm-up call, then the best of `repeats` passes
    of `runs` calls."""
    return benchmark(lambda _: fn(), [None] * runs, warmup=1, repeats=repeats,
                     device=device)["best_ms"]
