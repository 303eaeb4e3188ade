#!/usr/bin/env python3
"""Times the reduce (K5 and glu_tpu_torch.reduce) on one NVIDIA GPU, for the record.

    python3 tools/reduce_timings.py [--root DIR]   # from the root of the repository

--root imports glu_tpu_torch from DIR, a checkout of another commit (for
example one unpacked with `git archive` into smoke_checkout/, which
.gitignore lists), so that two commits can be timed on one card in turns,
one process each. Only entry points that every version of the package has
are called: glu_tpu_torch.reduce with backend="cuda" (K5, never a route to
torch) and _cuda_reduce.reduce_partitions on a (1, N) row.

Prints the card's name and power limit, then one line each for:
  - the device time (CUDA events around the call, median of REPS after a
    warm-up; the card waits for the host, so host time shows) of
    glu_tpu_torch.reduce of 2^28 u32 SUM, (2^26, 4) u32 SUM and (2^25, 4)
    f64 MIN, each beside the one torch call that computes the same function
    (torch.sum of the int32 words with an int32 accumulator, torch.amin);
  - the host time per call (from the call to its return, the card idle
    before each call, median of HOST_REPS) of K5's wrapper at 2^28 u32 SUM,
    of glu_tpu_torch.reduce, of torch.sum, and of the steps a wrapper takes:
    the argument checks, one torch.empty (or new_empty), entering
    torch.cuda.device, reading the current stream (as a torch.cuda.Stream or
    as its raw handle) and device, the library lookup, the library's entry
    called alone, and the wrapper with its launches replaced by a no-op;
  - the peak device memory a (2^26, 4) u32 reduce allocates beyond its input;
  - a torch.profiler trace of one (2^26, 4) u32 reduce: each launch's device
    time.
Needs a CUDA device and nvcc; writes nothing but the kernel build.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPS = 10
HOST_REPS = 200


def median_ms(torch, fn, reps: int = REPS) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def host_us(torch, fn, reps: int = HOST_REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(ROOT), help="directory that holds the glu_tpu_torch to time")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("reduce_timings: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sys.path.insert(1, str(ROOT))
    import glu_tpu_torch
    from chip_smoke import _profile_kernels
    from glu_tpu_torch import ReduceOperator as Op
    from glu_tpu_torch.ops import _common
    from glu_tpu_torch.ops import _cuda_reduce as cr

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    tag = f"[{gpu}] [{pathlib.Path(glu_tpu_torch.__file__).parent}]"
    print(gpu)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20260)

    def words(n: int) -> torch.Tensor:
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)

    w = words(1 << 28)
    u = w.view(torch.uint32)
    u2 = u.view(1, -1)
    glu_ms = median_ms(torch, lambda: glu_tpu_torch.reduce(u, backend="cuda"))
    lib_ms = median_ms(torch, lambda: torch.sum(w, dtype=torch.int32))
    print(f"time reduce 2^28 u32 SUM: glu_tpu_torch.reduce {glu_ms:.4f} ms, torch.sum(int32) {lib_ms:.4f} ms {tag}")
    one = torch.empty(0, dtype=torch.int32, device=dev)

    def enter_device():
        with torch.cuda.device(dev):
            pass

    steps = {
        "K5 wrapper reduce_partitions (1, 2^28)": lambda: cr.reduce_partitions(u2, Op.SUM),
        "glu_tpu_torch.reduce 2^28": lambda: glu_tpu_torch.reduce(u, backend="cuda"),
        "torch.sum(int32) 2^28": lambda: torch.sum(w, dtype=torch.int32),
        "step: check_partitions": lambda: cr.check_partitions(u2),
        "step: torch.empty((1,))": lambda: torch.empty((1,), dtype=torch.uint32, device=dev),
        "step: x.new_empty((1,))": lambda: u2.new_empty((1,)),
        "step: with torch.cuda.device(dev)": enter_device,
        "step: torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "step: torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
        "step: torch.cuda.current_device()": torch.cuda.current_device,
        "step: kernels(fold_tile=TILE)": lambda: _common.kernels(fold_tile=cr.TILE),
        "step: tensor.data_ptr()": one.data_ptr,
    }
    # the entry point alone: its first launch with fixed arguments (zeroed
    # tickets, which the one-launch kernel leaves at 0)
    lib, stream = _common.kernels(fold_tile=cr.TILE), torch.cuda.current_stream(dev).cuda_stream
    scratch, out = torch.zeros(8192, dtype=torch.int64, device=dev), torch.empty(1, dtype=torch.int32, device=dev)
    if hasattr(lib, "glu_reduce"):
        steps["step: lib.glu_reduce(...) alone"] = lambda: lib.glu_reduce(
            u2.data_ptr(), 1, 1 << 28, 1, cr.MAX_CTAS, 1, 0, scratch.data_ptr(), scratch.data_ptr() + 8 * 4096,
            out.data_ptr(), stream)
    else:
        steps["step: lib.glu_reduce_pass(...) alone, the first of two"] = lambda: lib.glu_reduce_pass(
            u2.data_ptr(), 1, 1 << 28, cr.MAX_CTAS, 1, 0, scratch.data_ptr(), stream)
    for label, fn in steps.items():
        print(f"host {label}: {host_us(torch, fn):.2f} us per call {tag}")
    real_launch = cr.launch
    cr.launch = lambda *args, **kwargs: None
    try:
        print(f"host K5 wrapper with its launches replaced by a no-op: "
              f"{host_us(torch, lambda: cr.reduce_partitions(u2, Op.SUM)):.2f} us per call {tag}")
    finally:
        cr.launch = real_launch
    del w, u, u2

    x = words(1 << 28).view(torch.uint32).view(1 << 26, 4)
    xw = x.view(torch.int32)
    glu_ms = median_ms(torch, lambda: glu_tpu_torch.reduce(x, backend="cuda"))
    lib_ms = median_ms(torch, lambda: torch.sum(xw, 0, dtype=torch.int32))
    print(f"time reduce (2^26, 4) u32 SUM: glu_tpu_torch.reduce {glu_ms:.4f} ms, "
          f"torch.sum(x, 0, dtype=int32) {lib_ms:.4f} ms {tag}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    glu_tpu_torch.reduce(x, backend="cuda")
    torch.cuda.synchronize()
    print(f"memory reduce (2^26, 4) u32 SUM: {torch.cuda.max_memory_allocated() - base} bytes allocated at the "
          f"peak beyond the 1 GiB input {tag}")
    for line in _profile_kernels(torch, lambda: glu_tpu_torch.reduce(x, backend="cuda")):
        print(f"profile reduce (2^26, 4) u32 SUM: {line} {tag}")
    del x, xw

    f = torch.rand((1 << 25, 4), dtype=torch.float64, device=dev, generator=gen)
    glu_ms = median_ms(torch, lambda: glu_tpu_torch.reduce(f, Op.MIN, backend="cuda"))
    lib_ms = median_ms(torch, lambda: torch.amin(f, 0))
    print(f"time reduce (2^25, 4) f64 MIN: glu_tpu_torch.reduce {glu_ms:.4f} ms, torch.amin(x, 0) {lib_ms:.4f} ms {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
