"""Timing (counterpart of glu_tpu/utils/timing.py).

The reference times a callback with a GL_TIME_ELAPSED query
(gl_utils.hpp:249-265). On the GPU the counterpart is a pair of CUDA events
on the current stream around the callback; on the CPU it is the host clock.
`trace()` wraps torch.profiler, the counterpart of jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _tensors(result):
    """Every tensor in result, through nested tuples, lists and dicts."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list, dict)):
        for item in result.values() if isinstance(result, dict) else result:
            yield from _tensors(item)


def measure_elapsed_time(callback: Callable[[], object], device=None) -> tuple[int, object]:
    """Run `callback`, returning (elapsed nanoseconds, result).

    On a CUDA `device` the time is the device time between two CUDA events
    recorded around the callback on the current stream, read after a
    synchronize. Otherwise it is host wall-clock time up to the end of the
    callback's device work: the device of every CUDA tensor in the result
    (through nested tuples, lists and dicts) is synchronized before the
    clock stops, as the JAX function blocks on its result.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = callback()
            end.record()
            end.synchronize()
            return int(start.elapsed_time(end) * 1e6), result
    start_ns = time.perf_counter_ns()
    result = callback()
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return time.perf_counter_ns() - start_ns, result


def ns_to_human_string(ns: float) -> str:
    """Autoscaling time formatter (reference test/util/StopWatch.hpp:11-32)."""
    if ns >= 1e9:
        return f"{ns / 1e9:.3f} s"
    if ns >= 1e6:
        return f"{ns / 1e6:.3f} ms"
    if ns >= 1e3:
        return f"{ns / 1e3:.3f} us"
    return f"{ns:.0f} ns"


class StopWatch:
    """Wall-clock stopwatch (reference test/util/StopWatch.hpp:34-59)."""

    def __init__(self):
        self._start = time.perf_counter_ns()

    def restart(self) -> None:
        self._start = time.perf_counter_ns()

    def elapsed_ns(self) -> int:
        return time.perf_counter_ns() - self._start

    def elapsed_human(self) -> str:
        return ns_to_human_string(self.elapsed_ns())


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context over the CPU and, where there is one, the GPU.
    Yields the profiler; on exit writes a Chrome trace to
    `log_dir`/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
