#!/usr/bin/env python3
"""The single-file distribution (dist/glu_tpu_torch_single.py) on one NVIDIA
GPU, imported alone: its kernels built from the CUDA sources it carries as
strings, into _build/ beside it, then one call on each kernel's path, on
backend "cuda", held bit for bit against the same call on backend "torch",
with its launch counts: radix_sort of 2^24 u32 pairs (digit_histograms once,
onesweep_pass 4 times) and of 16,384 pairs (sort_single_tile once), and
exclusive_scan (K4) and reduce (K5) of 2^24 u32 SUM.

    python3 tools/single_file_smoke.py [PATH]   # default: dist/glu_tpu_torch_single.py

Prints the build's seconds and the library's name, the launch counts on a
line of their own, and as its last line one JSON object: {"build_s",
"library", "launches": {case: counts}}. Exits 1 on any failure, and when
glu_tpu_torch, glu_tpu or jax was imported: the file must stand alone.
"""

import importlib
import json
import os
import sys
import time

import torch

N = 1 << 24
SMALL_N = 16384
KERNELS = ("digit_histograms", "onesweep_pass", "sort_single_tile", "exclusive_scan", "reduce")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("single_file_smoke: no CUDA device available", file=sys.stderr)
        return 1
    path = os.path.abspath(argv[0] if argv else os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                                              "dist", "glu_tpu_torch_single.py"))
    name = os.path.splitext(os.path.basename(path))[0]
    sys.path.insert(0, os.path.dirname(path))
    glu = importlib.import_module(name)
    build = importlib.import_module(f"{name}._build")
    counters = [importlib.import_module(f"{name}.ops.{m}") for m in ("_cuda_sort", "_cuda_scan", "_cuda_reduce")]

    so, seconds, _ = build.build()
    build.load_library()
    print(f"build: {len(build.kernel_sources())} sources from the file's strings -> {so} in {seconds:.1f} s")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def u32(n: int) -> torch.Tensor:
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen).view(torch.uint32)

    def iota(n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)

    def outputs(x) -> tuple:
        return (x,) if isinstance(x, torch.Tensor) else tuple(x)

    cases = {  # label: (call, arguments, launches in KERNELS' order)
        "radix_sort 2^24 pairs": (glu.radix_sort, (u32(N), iota(N)), (1, 4, 0, 0, 0)),
        f"radix_sort {SMALL_N} pairs": (glu.radix_sort, (u32(SMALL_N), iota(SMALL_N)), (0, 0, 1, 0, 0)),
        "exclusive_scan 2^24 u32 SUM": (glu.exclusive_scan, (u32(N),), (0, 0, 0, 1, 0)),
        "reduce 2^24 u32 SUM": (glu.reduce, (u32(N),), (0, 0, 0, 0, 1)),
    }
    launches = {}
    for label, (call, args, want) in cases.items():
        torch.cuda.synchronize()
        for m in counters:
            m.reset_launch_counts()
        got = call(*args, backend="cuda")
        torch.cuda.synchronize()
        counts = {k: v for m in counters for k, v in m.launch_counts().items()}
        launches[label] = tuple(counts[k] for k in KERNELS)
        if launches[label] != want:
            raise AssertionError(f"{label}: launched {KERNELS} {launches[label]}, want {want}")
        ref = call(*args, backend="torch")
        for i, (g, r) in enumerate(zip(outputs(got), outputs(ref))):
            if g.dtype != r.dtype or g.shape != r.shape or not torch.equal(g.view(torch.int32), r.view(torch.int32)):
                raise AssertionError(f"{label}: output {i} differs from backend 'torch'")
        print(f"{label}: backend cuda bit-identical to backend torch")
    print(f"launches {KERNELS}: {launches}")
    imported = [m for m in ("glu_tpu_torch", "glu_tpu", "jax") if m in sys.modules]
    if imported:
        raise AssertionError(f"the single file imported {imported}")
    print(json.dumps({"build_s": seconds, "library": so.name, "launches": launches}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"single_file_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
