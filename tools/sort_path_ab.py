#!/usr/bin/env python3
"""The engine's multi-tile sort as one library call (ops/_cuda_sort.py::
onesweep_sort) against the same launches through the per-pass wrappers
(digit_histograms, a cumsum, onesweep_pass a pass), at 2^24 and 2^28
key/value pairs on one NVIDIA GPU, in turns: the card's time of each
(CUDA events, 15 calls each, the card idle before each call) and its host
time (the call to its return).

    python3 tools/sort_path_ab.py
"""

import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from glu_tpu_torch.ops import _cuda_sort as cs  # noqa: E402

FULL = tuple(range(32))


def per_pass(keys, payloads, positions):
    groups = cs._pass_groups(positions)
    hist = cs.digit_histograms(keys, groups)
    for g, base in zip(groups, torch.cumsum(hist, 1, dtype=torch.int32) - hist):
        keys, payloads = cs.onesweep_pass(keys, payloads, g, base[: 1 << len(g)])
    return keys, payloads


def main() -> int:
    if not torch.cuda.is_available():
        print("sort_path_ab: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for n in (1 << 24, 1 << 28):
        k = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev)
        v = torch.arange(n, dtype=torch.int32, device=dev)
        fns = {"one call": lambda: cs.onesweep_sort(k, [v], FULL), "per pass": lambda: per_pass(k, [v], FULL)}
        for f in fns.values():
            f()
        times = {name: [] for name in fns}
        hosts = {name: [] for name in fns}
        for _ in range(15):
            for name, f in fns.items():
                torch.cuda.synchronize()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                t = time.perf_counter()
                f()
                hosts[name].append((time.perf_counter() - t) * 1e3)
                e.record()
                e.synchronize()
                times[name].append(s.elapsed_time(e))
        for name in fns:
            t = sorted(times[name])
            print(f"n=2^{n.bit_length() - 1} {name}: median {statistics.median(t):.4f} ms min {t[0]:.4f} "
                  f"max {t[-1]:.4f}; host {statistics.median(hosts[name]):.4f} ms", flush=True)
        del k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
