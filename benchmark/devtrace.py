"""The traced sub-window of a `--trace 1` run, and what is read from it.

`record` runs some steps under torch.profiler (CPU and CUDA activities),
inside a span "bench.window" that opens after a synchronize and closes
after one, each program call inside a span "bench.call" (the benchmark's
own spans, around the calls into the program). The Chrome trace is written
under the run's TMPDIR, read back and deleted. What is kept is a
`TraceData`: the device operations (kernels, memcpys, memsets) inside the
window, the calls' host durations, and the device's idle gaps, each
labelled by what the host was doing at its middle.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import warnings
from dataclasses import dataclass, field

WINDOW, CALL = "bench.window", "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    match = re.search(r"\w+_kernel\w*(<[^>]*>)?", name)
    if match:
        return match.group(0)
    return name.split("(")[0][:80]


@dataclass
class TraceData:
    """One rank's traced window; times in microseconds from its start."""

    window_us: float
    device_ops: list = field(default_factory=list)  # (short name, category, start, duration)
    calls_us: list = field(default_factory=list)  # host duration of each "bench.call" span
    gaps: list = field(default_factory=list)  # (host label, duration) of each idle gap

    @property
    def busy_us(self) -> float:
        """Time in which some device operation ran (the union)."""
        busy, end = 0.0, 0.0
        for _, _, start, dur in sorted(self.device_ops, key=lambda o: o[2]):
            lo, hi = max(start, end), start + dur
            if hi > lo:
                busy += hi - lo
            end = max(end, hi)
        return busy

    def idle_pct(self):
        """The share of the window that no device operation covers; None
        where the trace holds no device operation."""
        if not self.device_ops or self.window_us <= 0:
            return None
        return 100.0 * (1.0 - self.busy_us / self.window_us)

    def device_us(self, cats=("kernel",), match=None) -> float:
        return sum(d for name, cat, _, d in self.device_ops
                   if cat in cats and (match is None or re.search(match, name, re.IGNORECASE)))

    def count(self, cats=("kernel",)) -> int:
        return sum(1 for _, cat, _, _ in self.device_ops if cat in cats)


def _labels(host: list, times: list) -> list:
    """For each time (ascending), the innermost host event (name, start,
    end) running at it, as a label."""
    host = sorted(host, key=lambda h: h[1])
    active, nxt, labels = [], 0, []
    for t in times:
        while nxt < len(host) and host[nxt][1] <= t:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[2] >= t]
        if not active:
            labels.append("host: between ops")
            continue
        name = min(active, key=lambda h: h[2] - h[1])[0]
        labels.append(f"host: {name}" + (" (python)" if name == CALL else ""))
    return labels


def from_events(events: list) -> TraceData:
    """A TraceData from the events of a Chrome trace that holds one
    "bench.window" span."""
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} '{WINDOW}' spans, not one")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    ops, host, calls = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            lo, hi = max(start, w0), min(start + dur, w1)
            if hi > lo:
                ops.append((short_name(e["name"]), cat, lo - w0, hi - lo))
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append((e["name"], start - w0, start + dur - w0))
            if e["name"] == CALL:
                calls.append(dur)
    data = TraceData(window_us=w1 - w0, device_ops=ops, calls_us=calls)
    edge, spans = 0.0, []
    for _, _, start, dur in sorted(ops, key=lambda o: o[2]) + [("", "", w1 - w0, 0.0)]:
        if start > edge:
            spans.append((edge, start))
        edge = max(edge, start + dur)
    labels = _labels(host, [(a + b) / 2 for a, b in spans])
    data.gaps = [(label, b - a) for label, (a, b) in zip(labels, spans)]
    return data


def record(steps, sync, cuda: bool) -> TraceData:
    """Runs steps() (which wraps each program call in a CALL span) under
    the profiler and returns what the trace shows."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=activities) as prof:
                with record_function(WINDOW):
                    steps()
                    sync()
            prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return from_events(events)


def breakdown(traces: list) -> dict:
    """The ten device operations that took most time and the ten host
    labels under which the device idled longest, in seconds a rank."""

    def top(pairs) -> list:
        sums: dict = {}
        for name, us in pairs:
            sums[name] = sums.get(name, 0.0) + us / 1e6 / len(traces)
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top((name, d) for t in traces for name, _, _, d in t.device_ops),
            "idle_gaps": top(g for t in traces for g in t.gaps)}
