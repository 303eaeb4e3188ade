"""Runs one cell of BENCHMARK.json once: set-up, the measured window, the
traced sub-window, the check against the plain reference, and the result
line. Every cell, configuration, traffic mix and metric is found by its
name in BENCHMARK.json; nothing here names one.

The window: steps of the cell's workload (workload.py) from a synchronize
to a synchronize. A stream runs its steps back to back without waiting and
closes the window by a synchronize, so the drain counts; a closed loop
times each call on the host clock from the call until its synchronize
returns. A run of several ranks (dist.py) agrees on a number of steps
that fills `--seconds`, from the time of set-up's last steps. With
`--trace 1` a sub-window of `trace_steps` steps inside the window, a third
of the way in, runs under the profiler (devtrace.py).

The answers kept for the check: the steps drawn from the seed
(`Workload.sampled_steps`) and the last step of each pool entry, compared
once the window has closed, the peak memory has been read and the cache of
freed blocks emptied.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from . import devtrace, plugins
from .workload import Workload, op_class

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "glu_tpu")


@dataclass
class Setup:
    """Set-up's phases, each the seconds from the process's start at its
    end, and the seconds that the kernels' build compiled (0 where the
    library of the current sources was already built)."""

    t_start: float
    marks: dict = field(default_factory=dict)
    compile_s: float = 0.0

    def mark(self, phase: str) -> None:
        self.marks[phase] = time.time() - self.t_start

    def build(self) -> None:
        """Builds the kernels now, if they are not built, so that no call
        of set-up or of the window compiles them."""
        from glu_tpu_torch import _build

        self.compile_s = _build.build()[1]
        self.mark("build")


@dataclass
class Run:
    """What one run measured, on every rank together; read by the metric
    readers in metrics/."""

    config: dict
    traffic: dict
    steps: int = 0
    window_s: float = 0.0
    work: int = 0  # elements (pairs, for a sort) over the window, every rank's
    work_per_step: int = 0  # elements of one step on one rank (the largest pool entry's)
    latencies_s: list | None = None
    host_s: list | None = None  # a closed loop's calls outside the traced sub-window, call to return
    setup_s: float = 0.0
    setup_marks: dict = field(default_factory=dict)  # Setup.marks (of the slowest rank, after the parent's)
    compile_s: float = 0.0
    traces: list | None = None  # devtrace.TraceData, one a rank
    checks: dict = field(default_factory=dict)
    answers: int = 0
    wrong: int = 0
    memory_peak_bytes: int = 0
    forbidden: list = field(default_factory=list)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole (glu_tpu_torch is not glu_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_manifest(path: pathlib.Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(manifest: dict, name: str) -> tuple:
    """(cell, configuration, traffic) of a cell, each read from its file."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    config_entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(ROOT / config_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(manifest: dict, name: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that cell `name`
    reports: those that list it, or list no cells."""
    return [m for m in manifest[kind] if name in m.get("workloads", [name])]


def reader(metric: str):
    """metrics/<metric>.py."""
    return plugins.load("metrics", metric)


def syncer(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def window(work: Workload, seconds: float, trace: bool, sync, *, steps: int | None = None) -> dict:
    """The measured window (see the module's docstring). Returns steps,
    window_s, latencies_s, kept ({step: outputs}), trace and the wall
    clock at the window's start."""
    closed = work.traffic["loop"] == "closed"
    sampled = work.sampled_steps()
    kept, last = {}, {}
    latencies = [] if closed else None
    host = [] if closed else None
    cuda = work.device.type == "cuda"

    def one(i: int, span: bool) -> None:
        t = time.perf_counter()
        if span:
            with torch.profiler.record_function(devtrace.CALL):
                out = work.call(i)
        else:
            out = work.call(i)
        if closed:
            returned = time.perf_counter()
            sync()
            latencies.append(time.perf_counter() - t)
            if not span:
                host.append(returned - t)
        if i in sampled:
            kept[i] = out
        else:
            last[work.entry(i)] = (i, out)

    trace_steps = work.traffic["trace_steps"] if steps is None else min(work.traffic["trace_steps"], steps)
    traced = None
    sync()
    wall = time.time()
    t0 = time.perf_counter()
    i = 0
    while (i < steps) if steps is not None else (time.perf_counter() - t0 < seconds):
        due = (i >= (steps - trace_steps) // 3) if steps is not None else (time.perf_counter() - t0 >= seconds / 3)
        if trace and traced is None and due:
            first = i
            traced = devtrace.record(lambda: [one(j, True) for j in range(first, first + trace_steps)], sync, cuda)
            i += trace_steps
            continue
        one(i, False)
        i += 1
    sync()
    window_s = time.perf_counter() - t0
    kept.update(dict(last.values()))
    return {"steps": i, "window_s": window_s, "latencies_s": latencies, "host_s": host, "kept": kept,
            "trace": traced, "wall_start": wall}


def warm_up(work: Workload, sync) -> None:
    for i in range(work.traffic["warmup_steps"]):
        work.call(i)
    sync()


def finish(work: Workload, measured: dict, run: Run) -> Run:
    """Reads the peak memory, frees what the program holds, and checks the
    kept answers against the reference."""
    device = work.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    kept = measured.pop("kept")
    measured.clear()
    work.inputs.clear()  # the check makes them again from the seed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = work.check(kept)
    del kept
    run.checks, run.answers, run.wrong = got["numbers"], got["answers"], got["wrong"]
    run.forbidden = forbidden_modules()
    return run


def run_local(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: torch.device,
              t_start: float) -> Run:
    """A cell on one device, in this process."""
    setup = Setup(t_start)
    setup.mark("imports")
    sync = syncer(device)
    if device.type == "cuda":
        setup.build()
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        setup.mark("card")
    work = Workload(config, traffic, seed, device)
    sync()
    setup.mark("inputs")
    warm_up(work, sync)
    setup.mark("warm_up")
    measured = window(work, seconds, trace, sync)
    run = Run(config, traffic, steps=measured["steps"], window_s=measured["window_s"],
              latencies_s=measured["latencies_s"], host_s=measured["host_s"], setup_s=measured["wall_start"] - t_start,
              setup_marks=setup.marks, compile_s=setup.compile_s,
              traces=None if measured["trace"] is None else [measured["trace"]],
              work_per_step=max(work.work_per_step))
    run.work = sum(work.work_per_step[work.entry(i)] for i in range(run.steps))
    return finish(work, measured, run)


def card_info(count: int) -> dict:
    """The card's name (torch), and each card's power limit in watts
    (nvidia-smi), beside every number."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.split()
        info["power_limit_w"] = [float(w) for w in out[:count]]
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        info["power_limit_w"] = f"not read: {e}"
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float, device_type: str = "cuda",
             overrides: dict | None = None, patch: str | None = None) -> dict:
    """One run of cell `name`; the result line as a dict. device_type "cpu"
    rehearses on the CPU with the port's plain versions (the tests), at
    sizes that `overrides` ({"config": {...}, "traffic": {...}}) cut down;
    `patch` ("module:function") is called before set-up in every process
    that runs the program, and may return a function that undoes it."""
    manifest = load_manifest()
    cell, config, traffic = resolve(manifest, name)
    config.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    chips = cell["chips"]
    if chips > 1:
        from . import dist

        run = dist.run_ranks(config, traffic, seed, seconds, trace, chips, device_type, t_start, patch)
    else:
        undo = apply_patch(patch)
        try:
            device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
            run = run_local(config, traffic, seed, seconds, trace, device, t_start)
        finally:
            if undo:
                undo()
    if run.forbidden:
        raise RuntimeError(f"modules loaded that the benchmark may not load: {run.forbidden}")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(manifest, name, kind):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = card_info(chips) if device_type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": chips}
    info["memory_peak_bytes"] = run.memory_peak_bytes
    limits = op_class(traffic["op"]).limits
    checks = {k: {"value": v, "limit": limits[k]} for k, v in run.checks.items()}
    checks["answers_checked"] = {"value": run.answers, "limit": "at least 1"}
    correct = run.answers > 0 and all(v <= limits[k] for k, v in run.checks.items())
    result = {"correct": correct, "attempted": run.steps, "failed": run.wrong, "metrics": metrics, "device": info}
    if trace and run.traces:
        info["busy_s"] = sum(t.busy_us for t in run.traces) / len(run.traces) / 1e6
        info["window_s"] = max(t.window_us for t in run.traces) / 1e6
        result["breakdown"] = devtrace.breakdown(run.traces)
    result["setup"] = {"marks_s": run.setup_marks, "compile_s": run.compile_s}
    result["checks"] = checks
    return result


def apply_patch(patch: str | None):
    if not patch:
        return None
    module, fn = patch.split(":")
    return getattr(importlib.import_module(module), fn)()


def pin_environment() -> None:
    """What could move the routing or the caches: no backend override, the
    router's calibration file at a path under this run's TMPDIR that does
    not exist (so the shipped table is measured), and the compile caches in
    fixed directories inside the checkout (the kernels' own build directory
    is the package's `_build/`)."""
    import tempfile

    os.environ.pop("GLU_TPU_TORCH_BACKEND", None)
    absent = os.path.join(tempfile.gettempdir(), "glu_tpu_torch_benchmark", "absent", "router.json")
    if os.path.exists(absent):
        raise RuntimeError(f"{absent} exists: the router would read it in place of the shipped table")
    os.environ["GLU_TPU_TORCH_ROUTER_CALIBRATION"] = absent
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
