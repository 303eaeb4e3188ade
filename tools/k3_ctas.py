#!/usr/bin/env python3
"""K3 (sort_single_tile) on each number of CTAs that holds the input, from
256 to 65,536 key/value pairs (32 key bits, 4 passes) on one NVIDIA GPU:
the kernel alone by torch.profiler (the median of 30 launches traced
together; the configurations in turns, three rounds, each configuration's
median of its rounds' medians) and, for the engine's own choice and for
every CTA count, the wrapper's median ms over 20 calls between CUDA
events, and the same on the engine's own CTA count (single_tile_ctas).
Each output is checked against sort_single_tile_ref, bit for bit.

    python3 tools/k3_ctas.py [--sizes 1024,16384,65536] [--ctas 1,2,4,8]
"""

import argparse
import os
import statistics
import sys
import warnings

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from glu_tpu_torch.ops import _cuda_sort as cs  # noqa: E402

FULL = tuple(range(32))
SIZES = (256, 1024, 2048, 4096, 5120, 6144, 7168, 8192, 12288, 16384, 24576, 32768, 49152, 65536)
CTAS = (1, 2, 4, 8)


def traced_ms(fn, calls: int = 30):
    """Median device ms of the kernel launches of `calls` calls of fn,
    traced together by torch.profiler, or None when it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0)
    return times[len(times) // 2] if times else None


def wrapper_ms(fn, reps: int = 20) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--ctas", default=",".join(map(str, CTAS)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_ctas: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes = [int(s) for s in args.sizes.split(",")]
    ctas_set = [int(c) for c in args.ctas.split(",")]
    configs = {}
    for n in sizes:
        keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        want = cs.sort_single_tile_ref(keys, [vals], FULL)
        for c in ctas_set:
            if cs.single_tile_slice(n, c) > cs.SLICE_MAX:
                continue
            fn = (lambda k, v, c: lambda: cs.sort_single_tile(k, [v], FULL, ctas=c))(keys, vals, c)
            got_k, (got_v,) = fn()
            if not (torch.equal(got_k, want[0]) and torch.equal(got_v, want[1][0])):
                raise AssertionError(f"K3 on {c} CTAs at n={n} differs from sort_single_tile_ref")
            configs[(n, c)] = fn
    rounds = {key: [] for key in configs}
    for _ in range(3):
        for key, fn in configs.items():
            rounds[key].append(traced_ms(fn))
    for n in sizes:
        row = []
        for c in ctas_set:
            if (n, c) in configs:
                got = [t for t in rounds[(n, c)] if t is not None]
                kernel = f"{statistics.median(got):.4f}" if got else "not measured"
                row.append(f"{c} CTAs {kernel} (wrapper {wrapper_ms(configs[(n, c)]):.4f})")
        keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        shipped = cs.single_tile_ctas(n)
        wrap = wrapper_ms(lambda: cs.sort_single_tile(keys, [vals], FULL))
        print(f"K3 n={n} kernel ms (profiler; the wrapper's, events): " + ", ".join(row)
              + f"; the engine's choice, {shipped} CTAs: wrapper {wrap:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
