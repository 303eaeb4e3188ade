"""Timing and tracing (counterpart of glu_tpu/utils/timing.py).

The reference times a callback with a GL_TIME_ELAPSED query
(gl_utils.hpp:249-265). On the GPU the counterpart is a pair of CUDA events
on the current stream around the callback; on the CPU it is the host clock.
`trace()` wraps torch.profiler, the counterpart of jax.profiler.

The port's own tracing is one store a process, kept here:
  - `span(name)`: a context manager around a stage of a call, and
    `start(name)` / `stop()`, the same span at the cost of a call and a
    test when tracing is off. Each record holds the name, start and end
    (time.perf_counter_ns), its parent span and a call id: a public
    function opens a call id (`start_call`), and every span under it
    shares that id; nesting is tracked per thread.
  - `count(name, n=1)`: a counter, always on (an integer add);
    `declare(name)` lists a counter in summary() before it first counts.
  - `enable()` / `disable()`: spans on for an operator's own runs.
  - `summary()`: for each span name its count, total and self microseconds
    (duration less what its child spans cover), every counter, and each
    kernel module's launch counts as `launches.<kernel>`.
  - `records()`, `reset()`.

Spans record while enable() holds or while a torch.profiler records. The
profiler is checked once a public call, at its top-level span; the spans
inside read a module flag, so that with tracing off a span costs a call
and a test. While a profiler records, each span also enters the
profiler's own record function, so that it stands in the Chrome trace as
a `cpu_op` event of the same name, on the trace's clock. The store keeps
MAX_RECORDS raw records; past them summary() goes on counting.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
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


# ---------------------------------------------------------------------------
# the port's tracing: spans and counters
# ---------------------------------------------------------------------------

MAX_RECORDS = 1_000_000  # raw span records kept; past them summary() still counts every span

# the modules whose launch counts summary() reports, under the package's root
# (glu_tpu_torch, or the single file's module name)
_ROOT = __name__.rsplit(".", 2)[0]
_LAUNCH_MODULES = ("ops._cuda_sort", "ops._cuda_scan", "ops._cuda_reduce", "parallel._cuda_bucket")

_profiler_enabled = torch._C._autograd._profiler_enabled
_trace_event = torch._C._profiler._RecordFunctionFast

Record = collections.namedtuple("Record", "name start_ns end_ns parent call")

_enabled = False  # enable() holds
_on = False  # spans record: enable() holds, or a public call runs under a profiler
_profiling = False  # the running top-level public call is profiled: spans enter its trace too
_local = threading.local()  # .stack: the open spans of this thread, innermost last
_records: list = []  # [name, start, end, parent record or -1, call id], in the order they opened
_stats: dict = {}  # name -> [count, total ns, self ns]
_counters: dict = {}
_declared: set = set()  # counters that summary() lists from 0
_dropped = 0  # spans closed past MAX_RECORDS
_calls = 0  # call ids given out
_anchor = (time.perf_counter_ns(), time.time_ns())  # one reading of both clocks, for records()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One span: see span(), start() and start_call()."""

    __slots__ = ("name", "public", "top", "parent", "call", "index", "inner_ns", "event", "start")

    def __init__(self, name: str, public: bool = False):
        self.name, self.public = name, public

    def open(self):
        global _on, _profiling, _calls
        stack = _stack()
        self.top = False
        if stack:
            self.parent, self.call = stack[-1].index, stack[-1].call
        else:
            _calls += 1
            self.parent, self.call = -1, _calls
            if self.public:  # a public call at the top: the profiler is checked here, once a call
                self.top = True
                _profiling = _profiler_enabled()
                _on = True
        self.event = _trace_event(self.name) if _profiling else None
        if self.event is not None:
            self.event.__enter__()
        self.index = len(_records) if len(_records) < MAX_RECORDS else -1
        if self.index >= 0:
            _records.append([self.name, 0, 0, self.parent, self.call])
        self.inner_ns = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def close(self) -> None:
        global _on, _profiling, _dropped
        end = time.perf_counter_ns()
        took = end - self.start
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].inner_ns += took
        if self.event is not None:
            self.event.__exit__(None, None, None)
        stat = _stats.get(self.name)
        if stat is None:
            stat = _stats[self.name] = [0, 0, 0]
        stat[0] += 1
        stat[1] += took
        stat[2] += took - self.inner_ns
        if self.index >= 0:
            record = _records[self.index]
            record[1], record[2] = self.start, end
        else:
            _dropped += 1
        if self.top:
            _profiling = False
            _on = _enabled

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()


class _Off:
    """The span of tracing off: a null context."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def span(name: str):
    """A context manager that records a span `name` while tracing is on
    (enable(), or a public call under a profiler), else does nothing: for a
    stage that costs far more than a `with` statement (a host sync, a
    collective). On a call's own path use start() and stop()."""
    return _Span(name) if _on else _OFF


def start(name: str):
    """Opens a span `name` while tracing is on and returns it, else None;
    stop() closes it, in a `finally`. Off, it costs a call and a test,
    where a `with` statement costs several times more (PERF.md §6)."""
    return _Span(name).open() if _on else None


def start_call(name: str):
    """start() for a public function: a call at the top, with tracing off,
    checks whether a profiler records, and turns the spans on for the call
    if one does."""
    return _Span(name, public=True).open() if _on or _profiler_enabled() else None


def stop(opened) -> None:
    """Closes what start() or start_call() returned."""
    if opened is not None:
        opened.close()


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name`, whether tracing is on or off."""
    _counters[name] = _counters.get(name, 0) + n


def declare(name: str) -> None:
    """Makes summary() list the counter `name`, at 0 until it counts, so that
    a reader can tell a path that never ran from a counter that is not
    there."""
    _declared.add(name)


def enable() -> None:
    """Spans record from now on, with or without a profiler."""
    global _enabled, _on
    _enabled = _on = True


def disable() -> None:
    """Spans record only inside public calls under a profiler again."""
    global _enabled, _on
    _enabled = _on = False


def _launch_modules():
    """The kernel modules of this package that are loaded (a module not
    loaded has launched nothing)."""
    return [m for m in (sys.modules.get(f"{_ROOT}.{name}") for name in _LAUNCH_MODULES) if m is not None]


def summary() -> dict:
    """{"spans": {name: {"count", "total_us", "self_us"}}, "counters": {name:
    value}, "dropped": records not kept}: the counters include the declared
    ones and each loaded kernel module's launch counts, as launches.<kernel>."""
    counters = dict.fromkeys(_declared, 0)
    counters.update(_counters)
    for module in _launch_modules():
        counters.update((f"launches.{kernel}", n) for kernel, n in module.launch_counts().items())
    spans = {name: {"count": c, "total_us": t / 1e3, "self_us": own / 1e3} for name, (c, t, own) in _stats.items()}
    return {"spans": dict(sorted(spans.items())), "counters": dict(sorted(counters.items())), "dropped": _dropped}


def records() -> list:
    """The kept spans as Records, in the order they opened: name, start and
    end in nanoseconds on the Unix clock (time.time_ns's; a profiler's
    Chrome trace puts an event at baseTimeNanoseconds + 1000 * ts), the
    index of the parent record (-1: none kept) and the call id. A span still
    open has end_ns None."""
    shift = _anchor[1] - _anchor[0]
    return [Record(name, start + shift, end + shift if end else None, parent, call)
            for name, start, end, parent, call in _records]


def reset() -> None:
    """Empties the store (records, span totals, counters) and the loaded
    kernel modules' launch counts, and reads the two clocks again."""
    global _dropped, _anchor
    _records.clear()
    _stats.clear()
    _counters.clear()
    _dropped = 0
    for module in _launch_modules():
        module.reset_launch_counts()
    _anchor = (time.perf_counter_ns(), time.time_ns())


def _since(before: dict, after: dict) -> dict:
    """What summary() gained from `before` to `after`."""
    spans = {}
    for name, s in after["spans"].items():
        b = before["spans"].get(name)
        gained = s if b is None else {k: s[k] - b[k] for k in s}
        if gained["count"]:
            spans[name] = gained
    counters = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}
    return {"spans": spans, "counters": {k: v for k, v in counters.items() if v},
            "dropped": after["dropped"] - before["dropped"]}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context over the CPU and, where there is one, the GPU,
    with the program's spans on (every public call under it records them,
    and they stand in the trace beside the caller's events). Yields the
    profiler; on exit writes a Chrome trace to `log_dir`/trace.json and
    what summary() gained inside to `log_dir`/summary.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = summary()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    gained = _since(before, summary())
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(gained, f, indent=1)
