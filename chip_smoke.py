#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (glu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which raises (exit code 1) on any failure:
  1. device: a CUDA device is required; prints nvidia-smi's name and power
     limit and the torch/CUDA versions;
  2. build: compiles glu_tpu_torch/csrc/*.cu with nvcc for sm_90a, one nvcc
     per source, all at once;
  3. each sort kernel (digit_histograms, onesweep_pass, sort_single_tile)
     against its plain torch version on the card, bit for bit, at the main
     path's shape and at small ragged shapes: uniform, constant and 3-valued
     keys, 8-bit, 1-bit, top-byte and non-contiguous digits, 0, 1 and 7
     payloads; K3 at n = 1, 2, 1000 and CTA_MAX on one CTA, and on its
     cluster at CTA_MAX + 1, 10000, 24,576, 24,577, 32,768, 49,153, 65,535
     and its limit SINGLE_TILE_MAX, with 32 bits (4 passes of 8), 12 bits
     (8 + 4), the top byte and 5 scattered bits; K3 on every CTA count that
     holds 16,384, 49,153 and 65,536 elements, and a launch on too few CTAs
     raising GluError from the C entry's error; and the one-call multi-tile
     sort (onesweep_sort, which
     radix_sort runs) against the two wrappers it runs, pass by pass, with
     1, 2 and 4 passes, at the small ragged shape and at 2**28 pairs;
  4. the sort's main path: glu_tpu_torch.radix_sort on 2**28 u32 key/value
     pairs and on smaller and edge-case inputs, bit for bit against
     radix_sort(..., backend="torch") (one stable torch.sort) on the card;
  5. launch counts of the sort: the 2**28 sort ran digit_histograms once,
     onesweep_pass 4 times and sort_single_tile never, and so did a sort of
     SINGLE_TILE_MAX + 1 pairs; num_steps=3 (12 bits) 1 and 2 times; the
     sorts of 10,000, CTA_MAX + 1 and SINGLE_TILE_MAX pairs ran
     sort_single_tile alone;
  6. the sort variants at full width, each bit for bit against the same
     call with backend="torch", with the launch counts set to 0 before each
     call and checked after it: radix_sort_keys, radix_argsort(descending=
     True) on keys with heavy duplicates, radix_sort_f32 with +-0.0, +-inf
     and NaNs of both signs, radix_sort_i32, radix_sort(bits="auto") on keys
     below 2**10 (1 envelope histogram + 1 histogram + 2 passes), bits=(0, 3,
     9, 17, 31), radix_sort_u64 with duplicates (2 histograms + 8 passes),
     radix_sort_segmented over 4,096 uneven offsets and 4,096 partitions
     (2 + 4 + 2 passes), all at 2**28 pairs, and radix_sort_multi with 7 and
     9 payloads at 2**24; each again at 10,000 pairs (K3 alone); each
     full-size variant timed against backend="torch" in turns, and a
     per-launch profile of each 2**28 variant but i32 and explicit bits
     (their launches are those of the pair sort and of bits="auto");
  7. the scan and reduce kernels (exclusive_scan K4, reduce K5) against
     their plain torch versions on the card, for sum, mul, min and max on
     int32, uint32, float32 and float64, at ragged, partitioned, vector and
     the sort table's shapes, at the main path's 2**28 u32 and at 2**26 f64
     SUM (K4's look-back over 8K tiles of 8-byte status); integers bit for
     bit, floats at rtol 1e-4, atol 1e-3; K5 also on (P, L, C) rows of 2-
     and 4-vectors, on rows off a 16-byte boundary, on more rows than
     MAX_CTAS (one CTA a row, no ticket) and at the main path's (1, 2**26,
     4) u32 SUM and (1, 2**25, 4) f64 MIN, one launch each; and K4's and
     K5's f32 SUM and f64 MUL (K4 at (1, 2**22) and (64, 3 * TILE + 5), K5 at
     (1, 2**22) and (1, 2**20, 4)), launched 5 times, bit-identical from run
     to run;
  8. the scan and reduce main path: exclusive_scan, inclusive_scan and
     reduce of 2**28 u32, reduce of 2**28 f32 (MAX), reduce of (2**26, 4)
     u32 (SUM) and (2**25, 4) f64 (MIN) vector streams with under 1 MiB
     allocated (no copy of the 1 GiB input), exclusive_scan of 2**24 f32,
     segmented_reduce of 2**24 u32 over 10**4 uneven segments, and the
     BlellochScan and Reduce classes on DeviceBuffers made on the default
     device, each against backend="torch" or an exact reference; the launch
     counts, set to 0 before and read after, match the design (K4 1 launch
     per scan, K5 1 per reduce);
  9. timings (CUDA events, medians), for the record only, and a per-launch
     profile (torch.profiler) of one 2**28 sort, scan and reduce and of the
     two vector reduces; the vector reduces against torch.sum(x, 0) and
     torch.amin(x, 0); the host time per call of K5's wrapper and of
     torch.sum; K3's kernel alone (the profiler over 20 launches, and 200
     launches back to back between CUDA events), its wrapper, its host time per
     call and radix_sort at CTA_MAX, at 16,384 pairs and at SINGLE_TILE_MAX;
     K3 on 1, 2, 3, 4 and 8 CTAs, a line each, at 65,536 pairs or the most
     of 49,152, 32,768 and 16,384 that they hold; the crossover table of K3, the
     histogram + onesweep path through the per-pass wrappers and as one
     library call (onesweep_sort), torch.sort(stable) + gather, radix_sort
     on the kernels and routed, from 1,024 to 2**20 pairs; K3, onesweep_sort
     and torch.sort at 65,536 pairs after an L2 flush, in turns; and
     the 2**28-pair multi-tile sort as one call against the per-pass
     wrappers, in turns;
 10. the router guard (_router_guard): a quick calibration into a temporary
     file, then backend=None under the shipped table and under that file
     against backend "cuda" and "torch", in turns, for key/value sorts from
     1,024 to 2**28 pairs, keys-only, 2 payloads, one 8-bit pass, u64 and
     4,096 segments at 65,536, 2**20 and 2**24, and reduce at 2**12 to
     2**28: each routed time within 10% plus 0.010 ms of the faster
     backend's; an inverted model flagged at 2**28; the 2**28 routed sort
     on 1 + 4 launches; the host time of one routing decision;
 11. the distributed layer (_distributed_layer): on a 1-rank NCCL group,
     distributed_radix_sort of 2**28 pairs (1 + 4 launches), its f32, i32
     and u64 forms at 2**24 and 10,000 pairs (K3 alone), distributed_reduce
     and the distributed scans of 2**28 u32 SUM, each bit for bit against
     its single-card call, with the launch counts set to 0 before and read
     after (KB, the bucket kernel, never: one rank has no bucket stage),
     and a CPU tensor on the group raising; every rank's stages at D = 2, 4
     and 8 of a 2**28-pair global array in this process (the NCCL transfer
     replaced by slicing along ragged_exchange_plan), each rank's buckets
     (KB, counted) bit for bit against bucket_of_ref, joined bit for bit
     against radix_sort(backend="torch"); KB against its plain versions on
     constant keys, repeated splitters (fewer samples than ranks), a shard
     at a 4-byte offset, the 64-bit form at 2**24 (its words at one offset
     and at two) and D - 1 splitters on both sides of shared memory's
     SMEM_SPLITTERS; timings of the 1-rank sort against radix_sort, of KB
     at rank 0 of D = 4 against its plain version and torch.bucketize, and
     of rank 0's _bucket_of, partition and local sort at D = 4 beside their
     bounds. Its launches join the kernels line;
 12. the entry point and the single file (_entry_and_single_file): entry()'s
     fn on the card, one sort_single_tile launch (K3 on a cluster) and
     nothing else, bit for bit against backend "torch" and timed against
     torch.sort(stable) + gather (its launches join the kernels line);
     dryrun_multichip on the cards and over 2 gloo ranks; and
     tools/single_file_smoke.py in its own process, built from its strings.
Phases 3-9 and 11 check and time the kernels: each call passes backend="cuda", so
that the router cannot turn a kernel check into one of torch against torch.
No calibration file is read: the router uses the shipped table, and phase
10 its own files.
The last line is {"ok": true, "device": {...}}; the line before it is
nvidia-smi's line, and the one before that the JSON summary of the kernels.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 20260
MAIN_N = 1 << 28
# the vector reduces of the main path: 1 GiB each, like the 2**28 u32 stream
VEC_U32 = (MAIN_N // 4, 4)
VEC_F64 = (MAIN_N // 8, 4)
K3_N = 16384  # K3's timed shape in the kernels line (its limit before the 8-bit redesign)
CROSSOVER_N = (1024, 4096, 8192, 16384, 24576, 24577, 32768, 49152, 65536, 65537, 1 << 17, 1 << 18, 1 << 20)
K3_CTAS = (1, 2, 3, 4, 8)  # K3's CTA counts timed at 65,536 pairs, or the most of 49,152, 32,768, 16,384 they hold
# the router guard's cycles of its 4 entries up to 2**22 elements (3 calls
# of each a cycle), where the host's time is most of a call: on the H100 the
# median of a routed entry read up to 14% off that of the backend it took
# with 60 calls an entry, under 10% with 240 (PERF.md, the router's findings)
GUARD_CYCLES = 80
# and above 2**22 to 2**24, where one call is still under a millisecond: 5
# cycles (15 calls) once read a routed 1-pass sort of 2**24 23% off the same
# path's "cuda" on the H100 (PERF.md, the distributed layer's findings);
# 2**28 keeps 5
GUARD_CYCLES_TO_2_24 = 20
REPS = 3
FOLD_REPS = 10
# the least time of a kernel: the larger of its bytes over the memory rate
# and its operations over the f32 rate outside the tensor cores (H100 SXM,
# NVIDIA's data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
FLOAT_TOL = dict(rtol=1e-4, atol=1e-3)
# phase 11: the simulated ranks of a 2**28-pair global array, the samples a
# rank (the default of distributed_radix_sort) and the small sort (K3 alone)
DIST_WORLD_SIZES = (2, 4, 8)
DIST_SAMPLES = 8192
DIST_SMALL_N = 10_000
DIST_VARIANT_N = 1 << 24  # the f32, i32 and u64 distributed sorts
ROOT = os.path.dirname(os.path.abspath(__file__))
SINGLE_FILE_TIMEOUT_S = 600  # tools/single_file_smoke.py: the build (about 20 s on the H100) and 4 calls


def _bound(nbytes: float, ops: float):
    """(bound ms, what bounds it) for a kernel moving nbytes and doing ops."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def _ptxas_summary(log: str) -> list:
    """One line per compiled kernel from ptxas -v: its name with template
    arguments (OP, type, vector width, components), registers, shared
    memory, spills."""
    import re

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d([a-z][a-z_]*_kernel)(?:ILi(\d)E(\w)(?:Li(\d+)E)?(?:Li(\d+)E)?)?",
                          line)
        if entry:
            name = entry.group(1)
            if entry.group(2):  # template <OP, T[, VEC[, C]]>: T mangled as i, j, f or d
                name += "<" + ",".join(g for g in entry.groups()[1:] if g) + ">"
        elif "spill" in line:
            spill = "" if " 0 bytes spill stores, 0 bytes spill loads" in line else "; " + line.strip()
        elif "Used" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}{spill}")
            name, spill = None, ""
    return lines


def _profile_kernels(torch, fn) -> list:
    """Device time of each kernel launch of one warm call of fn, in launch
    order, from torch.profiler, then their sum against the same call's span
    by CUDA events, and the device's idle share of that span; "not measured"
    when the profiler sees no device time."""
    import re
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    lines, busy_ms = [], 0.0
    for evt in sorted(events, key=lambda e: e.time_range.start):
        us = evt.time_range.elapsed_us()
        if us > 0:
            name = re.search(r"\w+_kernel(<[^>]*>)?", evt.name)
            lines.append(f"{name.group(0) if name else evt.name[:60]} {us / 1e3:.4f} ms")
            busy_ms += us / 1e3
    if not lines:
        return ["kernel device times not measured (the profiler saw no device time)"]
    span_ms = start.elapsed_time(end)
    lines.append(f"the traced call: kernels {busy_ms:.4f} ms of its {span_ms:.4f} ms span by CUDA events, "
                 f"device idle {100 * (1 - busy_ms / span_ms):.1f}%")
    return lines


def _kernel_device_ms(torch, fn, calls: int = 20):
    """Median device ms of the kernel launches of `calls` calls of fn traced
    together by torch.profiler, or None when it saw no device time. One
    call of a kernel of well under a millisecond (K3's), traced alone late
    in this script, has shown none on the H100, where the same call traced
    early in a process of its own showed it."""
    import warnings

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


def _router_guard(torch, dev, gen, tag: str) -> None:
    """Phase 10: the router guard. A quick calibration into a temporary
    file; then, at each point, backend=None under the shipped table and
    under that file against backend "cuda" and "torch", one call at a time
    in an order in which each follows each other equally often, the median
    of 240 calls each (GUARD_CYCLES; 60 to 2**24, 15 above). Every routed time
    must be within 10% plus 0.010 ms of the faster backend's
    (router.within_guard). A model with the crossover inverted must be
    flagged at 2**28 pairs. Raises on a failure."""
    import os
    import tempfile

    import glu_tpu_torch as glu
    from glu_tpu_torch.ops import _cuda_reduce as cr
    from glu_tpu_torch.ops import _cuda_sort as cs
    from glu_tpu_torch.ops import router

    t0 = time.perf_counter()
    env = "GLU_TPU_TORCH_ROUTER_CALIBRATION"
    saved = os.environ.get(env)
    with tempfile.TemporaryDirectory(prefix="glu_router_") as tmp:
        paths = {name: os.path.join(tmp, f"{name}.json") for name in ("shipped", "fresh", "inverted")}

        def use(model: str) -> None:
            os.environ[env] = paths[model]  # "shipped" names no file: the shipped table
            router._reset_router_model()

        t_cal = time.perf_counter()
        fresh = router.calibrate(dev, quick=True, out=paths["fresh"], echo=lambda line: None)
        print(f"router: fresh calibration (--quick, {time.perf_counter() - t_cal:.1f} s): {json.dumps(fresh)}")
        shipped = router._H100_MODEL
        print(f"router: shipped table: {json.dumps(shipped)}")
        # the crossover inverted: the engine's host times 100x smaller, its per-key rates 100x larger
        inverted = dict(shipped, k3_fixed_us=shipped["k3_fixed_us"] / 100,
                        onesweep_fixed_us=shipped["onesweep_fixed_us"] / 100,
                        onesweep_pass_us=shipped["onesweep_pass_us"] / 100,
                        k3_ns_per_key_pass=[r * 100 for r in shipped["k3_ns_per_key_pass"]],
                        k3_cluster_fixed_us=shipped["k3_cluster_fixed_us"] / 100,
                        k3_cluster_ns_per_key_pass=[r * 100 for r in shipped["k3_cluster_ns_per_key_pass"]],
                        onesweep_hist_ns_per_key=shipped["onesweep_hist_ns_per_key"] * 100,
                        onesweep_ns_per_key_pass=[r * 100 for r in shipped["onesweep_ns_per_key_pass"]])
        with open(paths["inverted"], "w") as f:
            json.dump(inverted, f)

        w = torch.randint(-(2**31), 2**31, (MAIN_N,), dtype=torch.int32, device=dev, generator=gen)
        w2 = torch.randint(-(2**31), 2**31, (1 << 24,), dtype=torch.int32, device=dev, generator=gen)
        iota = torch.arange(MAIN_N, dtype=torch.int32, device=dev)
        u32 = lambda t: t.view(torch.uint32)  # noqa: E731

        def offsets(n: int) -> torch.Tensor:
            cuts = torch.sort(torch.randint(0, n + 1, (4095,), device=dev, generator=gen)).values
            return torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), n)])

        forms = {  # form -> n -> backend -> the call
            "key/value": lambda n: lambda b: lambda: glu.radix_sort(u32(w[:n]), u32(iota[:n]), backend=b),
            "keys-only": lambda n: lambda b: lambda: glu.radix_sort_keys(u32(w[:n]), backend=b),
            "multi, 2 payloads": lambda n: lambda b: lambda: glu.radix_sort_multi(
                u32(w[:n]), [u32(iota[:n]), u32(w2[:n])], backend=b),
            "bits=range(8) (1 pass)": lambda n: lambda b: lambda: glu.radix_sort(
                u32(w[:n]), u32(iota[:n]), bits=tuple(range(8)), backend=b),
            "u64": lambda n: lambda b: lambda: glu.radix_sort_u64(w[: 2 * n].view(torch.uint64), u32(iota[:n]),
                                                                  backend=b),
            "segmented, 4096 offsets": lambda n: (lambda offs: lambda b: lambda: glu.radix_sort_segmented(
                u32(w[:n]), u32(iota[:n]), offsets=offs, backend=b))(offsets(n)),
            "reduce u32 SUM": lambda n: lambda b: lambda: glu.reduce(u32(w[:n]), backend=b),
        }
        points = [("key/value", n) for n in (1024, 16384, 24577, 49152, 65536, 1 << 18, 1 << 20, 1 << 22, 1 << 24,
                                             MAIN_N)]
        points += [(form, n) for form in ("keys-only", "multi, 2 payloads", "bits=range(8) (1 pass)", "u64",
                                          "segmented, 4096 offsets") for n in (65536, 1 << 20, 1 << 24)]
        points += [("reduce u32 SUM", n) for n in (1 << 12, 1 << 16, 1 << 20, MAIN_N)]

        def launched(fn) -> tuple:
            """(histogram, onesweep, K3, K5) launches of one call."""
            torch.cuda.synchronize()
            cs.reset_launch_counts()
            cr.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            return (*cs.launch_counts().values(), cr.launch_counts()["reduce"])

        # each model read once through the router's own loader, then swapped
        # into the router's cache per call
        cost = {}
        for model in ("shipped", "fresh", "inverted"):
            use(model)
            cost[model] = router._cost_model(dev)

        flush = router.l2_flush(dev)

        # the order of the calls of 4 entries: a cycle of 12 in which each
        # entry follows each other entry once (every directed edge of K4). A
        # call after one of the other backend runs up to a fifth slower on
        # the H100 than after one of its own, so an order in which entries
        # followed some entries more often than others would favour them.
        cycle = (0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3)

        def cycles_ms(calls: dict, cycles: int) -> dict:
            """Median ms of each (model, fn) of `calls` (1 or 4 of them),
            timed one call at a time, each entry 3 times a cycle, so that
            the host's drift is shared (a warm-up first); the L2 cache
            flushed before each call, so that no call finds the inputs that
            the one before it left there."""
            names = list(calls)
            for name in names:
                if calls[name][0]:
                    router._models[dev.index] = cost[calls[name][0]]
                calls[name][1]()
            times = {name: [] for name in names}
            for _ in range(cycles):
                for name in (names * 3 if len(names) == 1 else [names[i] for i in cycle]):
                    model, fn = calls[name]
                    if model:
                        router._models[dev.index] = cost[model]
                    flush()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end))
            return {name: sorted(t)[len(t) // 2] for name, t in times.items()}

        failures, kv_times, main_launches = [], {}, None
        for form, n in points:
            make = forms[form](n)
            routes = {}
            for model in ("shipped", "fresh"):
                router._models[dev.index] = cost[model]
                ran = launched(make(None))
                routes[model] = "cuda" if sum(ran) else "torch"
                if (form, n, model) == ("key/value", MAIN_N, "shipped"):
                    main_launches = ran
            got = cycles_ms({"cuda": (None, make("cuda")), "torch": (None, make("torch")),
                             "shipped": ("shipped", make(None)), "fresh": ("fresh", make(None))},
                            GUARD_CYCLES if n <= 1 << 22 else GUARD_CYCLES_TO_2_24 if n <= 1 << 24 else 5)
            c_ms, t_ms = got["cuda"], got["torch"]
            for model in ("shipped", "fresh"):
                r_ms = got[model]
                ok = router.within_guard(r_ms, c_ms, t_ms)
                if not ok:
                    failures.append(f"{form} n={n} {model}: routed {routes[model]} {r_ms:.4f} ms, cuda {c_ms:.4f}, "
                                    f"torch {t_ms:.4f}")
                limit = (1 + router.GUARD_REL) * min(c_ms, t_ms) + router.GUARD_ABS_MS
                print(f"router guard {form} n={n} model={model}: route {routes[model]}, routed {r_ms:.4f} ms, "
                      f"backend cuda {c_ms:.4f} ms, backend torch {t_ms:.4f} ms, "
                      f"{'ok' if ok else 'OVER'} (limit {limit:.4f}) {tag}")
            if form == "key/value":
                kv_times[n] = (make, c_ms, t_ms, got["shipped"])
        _, c_ms, _, r_ms = kv_times[MAIN_N]
        print(f"router: radix_sort 2^28 pairs backend=None {r_ms:.3f} ms against backend cuda {c_ms:.3f} ms in turns "
              f"({100 * (r_ms / c_ms - 1):+.2f}%), launches histogram/onesweep/K3/K5 {main_launches} {tag}")
        if main_launches != (1, 4, 0, 0):
            failures.append(f"radix_sort 2^28 pairs backend=None launched {main_launches}, want (1, 4, 0, 0)")

        flagged = []  # a guard that cannot fail is no guard
        for n, (make, c_ms, t_ms, _) in kv_times.items():
            r_ms = cycles_ms({"inverted": ("inverted", make(None))}, 5 if n <= 1 << 20 else 1)["inverted"]
            if not router.within_guard(r_ms, c_ms, t_ms):
                flagged.append(n)
        print(f"router: the inverted model is flagged at key/value n in {flagged}")
        if MAIN_N not in flagged:
            failures.append(f"the inverted model was not flagged at 2^28 pairs (flagged: {flagged})")

        router._models[dev.index] = cost["shipped"]
        k = u32(w[:1024])
        calls = 20000
        for label, fn in (("_sort_backend, K3 regime (1,024 pairs)", lambda: router._sort_backend(None, k, 1024, 1, 4, True)),
                          ("_sort_backend, multi-tile regime (2^28 pairs)",
                           lambda: router._sort_backend(None, k, MAIN_N, 1, 4, True)),
                          ("_reduce_backend", lambda: router._reduce_backend(None, k))):
            fn()
            start = time.perf_counter()
            for _ in range(calls):
                fn()
            print(f"router: host time of one {label} decision: {(time.perf_counter() - start) / calls * 1e6:.2f} us "
                  f"(mean of {calls}) {tag}")
        del w, w2, iota, k
    if saved is None:
        os.environ.pop(env, None)
    else:
        os.environ[env] = saved
    router._reset_router_model()
    if failures:
        raise AssertionError("router guard: " + "; ".join(failures))
    print(f"router guard: every point within 10% + 0.010 ms of the faster backend, shipped table and fresh "
          f"calibration ({time.perf_counter() - t0:.1f} s)")


def _distributed_layer(torch, dev, gen, tag: str, median_ms, turns) -> dict:
    """Phase 11: the distributed layer (glu_tpu_torch.parallel).

    (a) A 1-rank NCCL group (init_process_group over a file:// store, on the
    card; destroyed at the end), the layer's main path with the launch
    counts set to 0 before it and read after it: distributed_radix_sort of
    2**28 u32 pairs (1 histogram + 4 passes), distributed_radix_sort_f32,
    _i32 and _u64 at 2**24, the sort of DIST_SMALL_N pairs (K3 alone), and
    distributed_reduce, distributed_exclusive_scan and
    distributed_inclusive_scan of 2**28 u32 SUM (K5 once, K4 twice); then
    each held bit for bit against its single-card call, counts and
    overflow checked, and a CPU tensor on the NCCL group must raise.
    (b) Every rank's stages at D = 4 and 8 of a 2**28-pair global array, in
    this process: local samples, splitters from their concatenation,
    _bucket_of, _partition_by_bucket on backend "cuda" and "torch" (bit for
    bit), the exchange by slicing along ragged_exchange_plan, and the local
    sorts, whose concatenation must be radix_sort(global, backend="torch"),
    stability included. Everything but the NCCL transfer.
    (c) Timings (CUDA events, medians): (a)'s sort against radix_sort in
    turns, and rank 0's _bucket_of, partition and local sort at D = 4, each
    beside its bytes over 3.35 TB/s.
    Returns the kernels' launches in (a)'s main path."""
    import tempfile

    import torch.distributed as dist

    import glu_tpu_torch as glu
    from glu_tpu_torch import GluError, ReduceOperator as Op
    from glu_tpu_torch import parallel
    from glu_tpu_torch.ops import _cuda_reduce as cr
    from glu_tpu_torch.ops import _cuda_scan as csc
    from glu_tpu_torch.ops import _cuda_sort as cs
    from glu_tpu_torch.parallel import _cuda_bucket as cb
    from glu_tpu_torch.parallel import dist_sort as ds

    t0 = time.perf_counter()
    u32 = lambda t: t.view(torch.uint32)  # noqa: E731

    def rand_words(n: int) -> torch.Tensor:
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)

    def iota(n: int) -> torch.Tensor:
        return u32(torch.arange(n, dtype=torch.int32, device=dev))

    def launch_counts() -> dict:
        torch.cuda.synchronize()
        return {**cs.launch_counts(), **csc.launch_counts(), **cr.launch_counts()}

    def same(label: str, got, want) -> None:
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape or g.device != w.device:
                raise AssertionError(f"{label} output {i}: {g.dtype} {tuple(g.shape)} on {g.device}, "
                                     f"want {w.dtype} {tuple(w.shape)} on {w.device}")
            if not torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)):
                raise AssertionError(f"{label} output {i}: differs from its reference")

    # -- (a) a 1-rank NCCL group ----------------------------------------------
    n24 = DIST_VARIANT_N
    specials = (0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000)
    f32 = torch.randn(n24, device=dev, generator=gen)
    f32.view(torch.int32)[torch.randint(0, n24, (len(specials) * 1000,), device=dev, generator=gen)] = \
        torch.tensor([p - (p >> 31 << 32) for p in specials], dtype=torch.int32, device=dev).repeat(1000)
    distinct = torch.randint(-(2**63), 2**63 - 1, (n24 // 4,), dtype=torch.int64, device=dev, generator=gen)
    u64 = distinct[torch.randint(0, n24 // 4, (n24,), device=dev, generator=gen)].view(torch.uint64)
    calls = {  # label: (distributed call, single-card call, launches histogram/onesweep/K3/K4/K5)
        "distributed_radix_sort 2^28 u32 pairs": (
            lambda a: parallel.distributed_radix_sort(*a, backend="cuda"),
            lambda a: glu.radix_sort(*a, backend="cuda"), (u32(rand_words(MAIN_N)), iota(MAIN_N)), (1, 4, 0, 0, 0)),
        "distributed_radix_sort_f32 2^24 with specials": (
            lambda a: parallel.distributed_radix_sort_f32(*a, backend="cuda"),
            lambda a: glu.radix_sort_f32(*a, backend="cuda"), (f32, iota(n24)), (1, 4, 0, 0, 0)),
        "distributed_radix_sort_i32 2^24": (
            lambda a: parallel.distributed_radix_sort_i32(*a, backend="cuda"),
            lambda a: glu.radix_sort_i32(*a, backend="cuda"), (rand_words(n24), iota(n24)), (1, 4, 0, 0, 0)),
        "distributed_radix_sort_u64 2^24 with duplicates": (
            lambda a: parallel.distributed_radix_sort_u64(*a, backend="cuda"),
            lambda a: glu.radix_sort_u64(*a, backend="cuda"), (u64, iota(n24)), (2, 8, 0, 0, 0)),
        f"distributed_radix_sort {DIST_SMALL_N} u32 pairs": (
            lambda a: parallel.distributed_radix_sort(*a, backend="cuda"),
            lambda a: glu.radix_sort(*a, backend="cuda"), (u32(rand_words(DIST_SMALL_N)), iota(DIST_SMALL_N)),
            (0, 0, 1, 0, 0)),
        "distributed_reduce 2^28 u32 SUM": (
            lambda a: (parallel.distributed_reduce(*a, backend="cuda"),),
            lambda a: (glu.reduce(*a, backend="cuda"),), (u32(rand_words(MAIN_N)),), (0, 0, 0, 0, 1)),
    }
    scan_in = calls["distributed_reduce 2^28 u32 SUM"][2]
    calls["distributed_exclusive_scan 2^28 u32 SUM"] = (
        lambda a: (parallel.distributed_exclusive_scan(*a, backend="cuda"),),
        lambda a: (glu.exclusive_scan(*a, backend="cuda"),), scan_in, (0, 0, 0, 1, 0))
    calls["distributed_inclusive_scan 2^28 u32 SUM"] = (
        lambda a: (parallel.distributed_inclusive_scan(*a, backend="cuda"),),
        lambda a: (glu.inclusive_scan(*a, backend="cuda"),), scan_in, (0, 0, 0, 1, 0))
    kernel_order = ("digit_histograms", "onesweep_pass", "sort_single_tile", "exclusive_scan", "reduce")
    with tempfile.TemporaryDirectory(prefix="glu_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            print(f"distributed (a): 1-rank group, backend {dist.get_backend()}")
            outs, per_call = {}, {}
            torch.cuda.synchronize()
            for m in (cs, csc, cr, cb):
                m.reset_launch_counts()
            for label, (dist_call, _, args, _) in calls.items():  # the main path: these launches count
                before = launch_counts()
                outs[label] = dist_call(args)
                after = launch_counts()
                per_call[label] = tuple(after[k] - before[k] for k in kernel_order)
            launched = launch_counts()
            if cb.launch_counts()["bucket_of"]:
                raise AssertionError(f"a 1-rank group launched KB: {cb.launch_counts()}")
            for label, (_, single_call, args, want_launches) in calls.items():
                got = outs.pop(label)
                if per_call[label] != want_launches:
                    raise AssertionError(f"{label}: launched histogram/onesweep/K3/K4/K5 {per_call[label]}, "
                                         f"want {want_launches}")
                if len(got) == 4:  # a sort: keys, values, counts, overflow
                    n = args[0].shape[0]
                    if got[2].tolist() != [n] or got[3].tolist() != [0] or got[2].dtype != torch.int32:
                        raise AssertionError(f"{label}: counts {got[2].tolist()}, overflow {got[3].tolist()}")
                    got = got[:2]
                same(label, got, single_call(args))
                print(f"distributed (a) {label}: bit-identical to the single-card call, launches "
                      f"histogram/onesweep/K3/K4/K5 {per_call[label]}")
            for label, fn in (("distributed_radix_sort", lambda c: parallel.distributed_radix_sort(c, c)),
                              ("distributed_reduce", lambda c: parallel.distributed_reduce(c)),
                              ("distributed_exclusive_scan", lambda c: parallel.distributed_exclusive_scan(c))):
                try:
                    fn(u32(torch.arange(1000, dtype=torch.int32)))
                except GluError:
                    continue
                raise AssertionError(f"{label} took a CPU tensor on the NCCL group")
            print("distributed (a): a CPU tensor on the NCCL group raises GluError in each function")
            sort_args = calls["distributed_radix_sort 2^28 u32 pairs"][2]
            d1_ms, single_ms = turns(lambda: parallel.distributed_radix_sort(*sort_args, backend="cuda"),
                                     lambda: glu.radix_sort(*sort_args, backend="cuda"))
        finally:
            dist.destroy_process_group()
    del calls, outs, scan_in, sort_args, f32, u64, distinct
    missing = [k for k in kernel_order if launched[k] < 1]
    if missing:
        raise AssertionError(f"the distributed path never launched {missing}: {launched}")
    print(f"distributed (a): launch counts over its main path {launched}")
    print(f"time distributed_radix_sort 2^28 pairs, 1 rank: {d1_ms:.3f} ms; radix_sort {single_ms:.3f} ms "
          f"({100 * (d1_ms / single_ms - 1):+.2f}%) {tag}")

    # -- (b) every rank's stages at D = 2, 4 and 8, in one process -------------
    keys, values = u32(rand_words(MAIN_N)), iota(MAIN_N)
    want_k, want_v = glu.radix_sort(keys, values, backend="torch")
    timed = {}  # rank 0 at D = 4: its shard, splitters and buckets
    bucket_err = 0

    def check_buckets(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
        nonlocal bucket_err
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise AssertionError(f"KB {label}: {got.dtype} {tuple(got.shape)}, want int32 {tuple(want.shape)}")
        err = int((got - want).abs().max()) if got.numel() else 0
        bucket_err = max(bucket_err, err)
        if err:
            raise AssertionError(f"KB {label}: differs from its plain version (max abs err {err})")

    def splitters_of(words: list, world: int, samples: int = DIST_SAMPLES) -> tuple:
        """The splitters of `world` ranks' shards of the global words: every
        rank's local samples, gathered in rank order (u32 or (hi, lo))."""
        n = words[0].shape[0] // world
        if len(words) == 1:
            local = [ds._local_samples(words[0][r * n:(r + 1) * n], r, samples) for r in range(world)]
            return ds._sample_splitters(torch.cat([s for s, _ in local]), torch.cat([i for _, i in local]), world)
        local = [ds._local_samples64(words[0][r * n:(r + 1) * n], words[1][r * n:(r + 1) * n], r, samples)
                 for r in range(world)]
        return ds._sample_splitters64(*(torch.cat([loc[j] for loc in local]) for j in range(3)), world)

    torch.cuda.synchronize()
    cb.reset_launch_counts()  # KB's main path: the bucket stage of every rank
    for world in DIST_WORLD_SIZES:
        n = MAIN_N // world
        shards = [(keys[r * n:(r + 1) * n], values[r * n:(r + 1) * n]) for r in range(world)]
        splitters = splitters_of([keys], world)
        parts, part_launches = [], []
        for r, (k, v) in enumerate(shards):
            bucket = ds._bucket_of(k, r, *splitters, "cuda")
            check_buckets(f"D={world} rank {r}", bucket, cb.bucket_of_ref(k, r * n, *splitters))
            before = launch_counts()
            part = ds._partition_by_bucket(bucket, [k, v], world, "cuda")
            after = launch_counts()
            part_launches.append(tuple(after[x] - before[x] for x in kernel_order[:3]))
            ref = ds._partition_by_bucket(bucket, [k, v], world, "torch")
            same(f"_partition_by_bucket D={world} rank {r}", [*part[0], *part[1:]], [*ref[0], *ref[1:]])
            del ref
            parts.append(part)
            if world == 4 and r == 0:
                timed = {"keys": k, "values": v, "splitters": splitters, "bucket": bucket}
            del bucket
        counts = torch.stack([p[1] for p in parts]).cpu()  # (source, destination)
        offsets = torch.stack([p[2] for p in parts]).cpu()
        starts, sizes, total = ds.ragged_exchange_plan(counts, int(counts.sum()))
        out_k, out_v = [], []
        for d in range(world):
            recv = [torch.empty(int(total[d]), dtype=torch.uint32, device=dev) for _ in range(2)]
            for s, ((pk, pv), _, _) in enumerate(parts):
                src = slice(int(offsets[s, d]), int(offsets[s, d]) + int(sizes[s, d]))
                dst = slice(int(starts[s, d]), int(starts[s, d]) + int(sizes[s, d]))
                recv[0][dst].view(torch.int32).copy_(pk[src].view(torch.int32))
                recv[1][dst].view(torch.int32).copy_(pv[src].view(torch.int32))
            before = launch_counts()
            sk, sv = glu.radix_sort(*recv, backend="cuda")
            after = launch_counts()
            if tuple(after[x] - before[x] for x in kernel_order[:3]) != (1, 4, 0):
                raise AssertionError(f"local sort D={world} rank {d}: launches {after}, {before}")
            if world == 4 and d == 0:
                timed["received"] = recv
            out_k.append(sk)
            out_v.append(sv)
        same(f"D={world} ranks' sorts joined", [torch.cat(out_k), torch.cat(out_v)], [want_k, want_v])
        print(f"distributed (b) D={world}: every rank's KB buckets bit-identical to bucket_of_ref; {world} ranks' "
              f"stages joined are bit-identical to radix_sort(backend='torch') of 2^28 pairs; received per rank "
              f"{total.tolist()} (largest {int(total.max()) / n:.4f} x n_local); partitions launched "
              f"histogram/onesweep/K3 {sorted(set(part_launches))}")
        del shards, parts, out_k, out_v, recv, sk, sv
    torch.cuda.synchronize()
    launched["bucket_of"] = cb.launch_counts()["bucket_of"]
    if launched["bucket_of"] != sum(DIST_WORLD_SIZES):
        raise AssertionError(f"the ranks' bucket stages launched KB {launched['bucket_of']} times, want "
                             f"{sum(DIST_WORLD_SIZES)} (one a rank)")
    print(f"distributed (b): KB launched {launched['bucket_of']} times, once a rank of D = {DIST_WORLD_SIZES}")
    del want_k, want_v

    # KB's edge cases against its plain versions (these launches do not count)
    def kb_case(label: str, shard_keys: list, splitters: tuple, base: int) -> None:
        fn, ref = (cb.bucket_of, cb.bucket_of_ref) if len(shard_keys) == 1 else (cb.bucket_of64, cb.bucket_of64_ref)
        check_buckets(label, fn(*shard_keys, base, *splitters), ref(*shard_keys, base, *splitters))

    kb_cases = 0
    constant = u32(torch.full((MAIN_N // 4,), 0x5EADBEEF, dtype=torch.int32, device=dev))
    sp = splitters_of([constant], 4)
    for r in range(4):  # every bucket decided by the global index
        n = constant.shape[0] // 4
        kb_case(f"constant keys, D=4 rank {r}", [constant[r * n:(r + 1) * n]], sp, r * n)
        kb_cases += 1
    few = u32(rand_words(3))  # 3 samples for 8 ranks: 7 splitters, repeated
    sp = ds._sample_splitters(few, torch.tensor([5, 1 << 20, 1 << 26], dtype=torch.int64, device=dev), 8)
    kb_case("repeated splitters (3 samples, D=8)", [keys[: 1 << 26]], sp, 0)
    n = (1 << 26) - 5  # a slice at a 4-byte offset with a ragged tail
    sp = splitters_of([keys[: 4 * n]], 4)
    for off in (1, 2, 3):
        kb_case(f"shard at a {4 * off}-byte offset", [keys[off:off + n]], sp, 3 * n)
    kb_cases += 4
    n24 = 1 << 24
    hi = u32(rand_words(n24 // 8).repeat(8)[torch.randperm(n24, device=dev, generator=gen)])  # duplicates
    lo = u32(rand_words(n24))
    sp = splitters_of([hi, lo], 4)
    for r in range(4):
        q = n24 // 4
        kb_case(f"64-bit 2^24, D=4 rank {r}", [hi[r * q:(r + 1) * q], lo[r * q:(r + 1) * q]], sp, r * q)
    kb_case("64-bit, hi and lo at one 4-byte offset", [hi[1:1 + q], lo[1:1 + q]], sp, q)
    kb_case("64-bit, hi and lo at two offsets", [hi[1:1 + q], lo[2:2 + q]], sp, q)
    kb_cases += 6
    n22 = 1 << 22
    for world in (cb.SMEM_SPLITTERS + 1, cb.SMEM_SPLITTERS + 2, 4097):  # D - 1 in, just past and past shared memory
        kb_case(f"D-1={world - 1} splitters", [keys[:n22]], splitters_of([keys[: 4096 * world]], world, 16), 0)
        kb_case(f"64-bit, D-1={world - 1} splitters", [hi[:n22], lo[:n22]],
                splitters_of([hi[: 1024 * world], lo[: 1024 * world]], world, 16), 0)
        kb_cases += 2
    del constant, few, hi, lo, sp
    print(f"distributed (b): KB bit-identical to bucket_of_ref / bucket_of64_ref in {kb_cases} more cases "
          f"(max abs err {bucket_err})")

    # -- (c) timings ---------------------------------------------------------------
    k, v, splitters, bucket = timed["keys"], timed["values"], timed["splitters"], timed["bucket"]
    n = k.shape[0]
    kb_ms, kb_plain_ms = turns(lambda: cb.bucket_of(k, 0, *splitters), lambda: cb.bucket_of_ref(k, 0, *splitters),
                              reps=FOLD_REPS)
    # torch.bucketize is not the same function: it counts splitter keys <=
    # each key and ignores the index tiebreak; on the keys' int32 order-form
    kw, sw = cb.ordered(k), cb.ordered(splitters[0])
    bucketize_ms = median_ms(lambda: torch.bucketize(kw, sw, out_int32=True, right=True), reps=FOLD_REPS)
    del kw, sw
    kb_bound = _bound(8 * n, n * (4 - 1).bit_length())  # a lexicographic step a splitter level
    timings = {
        "_bucket_of": (median_ms(lambda: ds._bucket_of(k, 0, *splitters, "cuda")), 8 * n),
        "_partition_by_bucket": (median_ms(lambda: ds._partition_by_bucket(bucket, [k, v], 4, "cuda")), 24 * n),
        "local radix_sort": (median_ms(lambda: glu.radix_sort(*timed["received"], backend="cuda")),
                             16 * timed["received"][0].shape[0]),
    }
    del timed, k, v, bucket, keys, values
    print(f"time bucket_of (KB), rank 0 of D=4 ({n} u32 keys, 3 splitters): kernel {kb_ms:.4f} ms, plain torch "
          f"{kb_plain_ms:.4f} ms, torch.bucketize (no index tiebreak) {bucketize_ms:.4f} ms, bound "
          f"{kb_bound[0]:.4f} ms ({kb_bound[1]}) {tag}")
    for label, (ms, nbytes) in timings.items():
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time {label}, rank 0 of D=4 (2^26 pairs a rank): {ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes} bytes over 3.35 TB/s) {tag}")
    print(f"distributed layer: phase 11 passed ({time.perf_counter() - t0:.1f} s)")
    row = {"ms": kb_ms, "plain_ms": kb_plain_ms, "bound": kb_bound, "library_ms": bucketize_ms,
           "max_abs_err": bucket_err}
    return launched, row


def _entry_and_single_file(torch, tag: str, turns) -> dict:
    """Phase 12: the entry point (glu_tpu_torch/entry.py) and the single
    file (dist/glu_tpu_torch_single.py); see the module's docstring. Returns
    the kernels' launches in (a), the entry's one call."""
    from glu_tpu_torch import _build, radix_sort
    from glu_tpu_torch.entry import dryrun_multichip, entry
    from glu_tpu_torch.ops import _cuda_reduce as cr
    from glu_tpu_torch.ops import _cuda_scan as csc
    from glu_tpu_torch.ops import _cuda_sort as cs

    t0 = time.perf_counter()
    # -- (a) entry() on the card --------------------------------------------------
    fn, args = entry()
    torch.cuda.synchronize()
    for m in (cs, csc, cr):
        m.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    launched = {**cs.launch_counts(), **csc.launch_counts(), **cr.launch_counts()}
    want = {"digit_histograms": 0, "onesweep_pass": 0, "sort_single_tile": 1, "exclusive_scan": 0, "reduce": 0}
    if launched != want:
        raise AssertionError(f"entry()'s fn launched {launched}, want {want}")
    ref = radix_sort(*args, backend="torch")
    for i, (g, r) in enumerate(zip(out, ref)):
        if g.dtype != torch.uint32 or g.shape != args[0].shape or not torch.equal(g.view(torch.int32),
                                                                                  r.view(torch.int32)):
            raise AssertionError(f"entry()'s fn output {i} differs from radix_sort(backend='torch')")
    keys, values = (a.view(torch.int32) for a in args)

    def sort_and_gather():
        r = torch.sort(keys, stable=True)
        return r.values, values[r.indices]

    entry_ms, lib_ms = turns(lambda: fn(*args), sort_and_gather, reps=20)
    print(f"entry (a): fn(*args) on {args[0].shape[0]} u32 pairs on {args[0].device} bit-identical to "
          f"radix_sort(backend='torch'), launches {launched}")
    print(f"time entry() fn ({args[0].shape[0]} pairs): {entry_ms:.4f} ms; torch.sort(stable)+gather "
          f"{lib_ms:.4f} ms {tag}")
    del fn, args, out, ref, keys, values

    # -- (b) dryrun_multichip on the cards and over gloo ------------------------------
    torch.cuda.empty_cache()
    for n, device in ((min(torch.cuda.device_count(), 4), None), (2, "cpu")):
        t = time.perf_counter()
        dryrun_multichip(n, device=device)
        print(f"entry (b): dryrun_multichip({n}, device={device!r}) passed in {time.perf_counter() - t:.1f} s")

    # -- (c) the single file, alone in a process ---------------------------------------
    shutil.rmtree(os.path.join(ROOT, "dist", "_build"), ignore_errors=True)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "single_file_smoke.py")],
                          capture_output=True, text=True, timeout=SINGLE_FILE_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        print(f"single file: {line}")
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr)
        raise AssertionError(f"tools/single_file_smoke.py exited with {proc.returncode}")
    result = json.loads(proc.stdout.splitlines()[-1])
    package_library = _build._library_path().name
    if result["library"] != package_library or not result["build_s"] > 0:
        raise AssertionError(f"the single file built {result['library']} in {result['build_s']} s; the package's "
                             f"library is {package_library}")
    print(f"single file: built from its strings in {result['build_s']:.3f} s, library {result['library']} = the "
          f"package's {tag}")
    print(f"entry and single file: phase 12 passed ({time.perf_counter() - t0:.1f} s)")
    return launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    # the shipped router table (no calibration file exists at this path), no override
    os.environ["GLU_TPU_TORCH_ROUTER_CALIBRATION"] = os.path.join(tempfile.gettempdir(),
                                                                  f"glu_tpu_torch_none_{os.getpid()}.json")
    os.environ.pop("GLU_TPU_TORCH_BACKEND", None)
    import glu_tpu_torch
    from glu_tpu_torch import _build
    from glu_tpu_torch.ops import _cuda_sort as cs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # -- 1. device --------------------------------------------------------
    gpu = _gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | python {sys.version.split()[0]}")

    # -- 2. build -----------------------------------------------------------
    so, seconds, log = _build.build()
    _build.load_library()
    print(f"build: nvcc sm_90a -> {so.name} in {seconds:.1f} s")
    for line in _ptxas_summary(log):
        print("  ptxas:", line)

    def words(n: int, kind_: str) -> torch.Tensor:
        if kind_ == "uniform":
            return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
        if kind_ == "constant":
            return torch.full((n,), 0x5EADBEEF, dtype=torch.int32, device=dev)
        if kind_ == "mod3":
            return torch.randint(0, 3, (n,), dtype=torch.int32, device=dev, generator=gen)
        if kind_ == "presorted":
            return torch.arange(n, dtype=torch.int32, device=dev)
        if kind_ == "reversed":
            return torch.arange(n, dtype=torch.int32, device=dev).flip(0)
        raise ValueError(kind_)

    max_err = {"digit_histograms": 0, "onesweep_pass": 0, "sort_single_tile": 0}

    def check_same(name: str, label: str, got, want) -> None:
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise AssertionError(f"{name} {label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
            if g.numel():
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        max_err[name] = max(max_err[name], err)
        if err:
            raise AssertionError(f"{name} {label}: differs from its plain version (max abs err {err})")

    # -- 3. each kernel against its plain version -----------------------------
    t0 = time.perf_counter()
    n_small = 3 * cs.TILE + 777  # three full tiles and a ragged tail
    scattered = (30, 3, 17, 9, 0, 22, 5, 12)
    pass_cases = [(n_small, kd, pos, ns) for kd in ("uniform", "constant", "mod3")
                  for pos in (tuple(range(8)), (8,), tuple(range(24, 32)), scattered) for ns in (0, 1, 7)]
    pass_cases.append((MAIN_N, "uniform", tuple(range(8)), 1))  # the main path's first pass
    for n, kd, pos, ns in pass_cases:
        label = f"n={n} keys={kd} bits={pos} payloads={ns}"
        keys = words(n, kd)
        pays = [torch.arange(n, dtype=torch.int32, device=dev)] + [words(n, "uniform") for _ in range(ns - 1)]
        pays = pays[:ns]
        hist = cs.digit_histograms(keys, [pos])
        check_same("digit_histograms", label, [hist], [cs.digit_histograms_ref(keys, [pos])])
        base = (torch.cumsum(hist, 1, dtype=torch.int32) - hist)[0, : 1 << len(pos)]
        got_k, got_p = cs.onesweep_pass(keys, pays, pos, base)
        want_k, want_p = cs.onesweep_pass_ref(keys, pays, pos, base)
        check_same("onesweep_pass", label, [got_k, *got_p], [want_k, *want_p])
        del keys, pays, hist, base, got_k, got_p, want_k, want_p
    hist_groups = [tuple(range(0, 8)), tuple(range(8, 16)), tuple(range(16, 24)), tuple(range(24, 32))]
    keys = words(MAIN_N, "uniform")  # the main path's histograms: every pass at once
    check_same("digit_histograms", "n=2^28 4 passes", [cs.digit_histograms(keys, hist_groups)],
               [cs.digit_histograms_ref(keys, hist_groups)])
    del keys
    # the one-call sort (glu_onesweep_sort: the histogram's last CTA writes
    # the digit starts, the passes write the outputs and a scratch buffer in
    # turn) against the two wrappers it runs, pass by pass; 2^28 pairs take
    # one status region zeroed a pass, the small sizes one region a pass
    fused_cases = [(n_small, kd, pos, ns) for kd in ("uniform", "mod3")
                   for pos in (tuple(range(32)), tuple(range(8)), scattered + (31,)) for ns in (0, 1, 7)]
    fused_cases.append((MAIN_N, "uniform", tuple(range(32)), 1))  # the main path
    for n, kd, pos, ns in fused_cases:
        keys = words(n, kd)
        pays = ([torch.arange(n, dtype=torch.int32, device=dev)] + [words(n, "uniform") for _ in range(ns - 1)])[:ns]
        got_k, got_p = cs.onesweep_sort(keys, pays, pos)
        groups = cs._pass_groups(pos)
        hist = cs.digit_histograms(keys, groups)
        want_k, want_p = keys, pays
        for g, base in zip(groups, torch.cumsum(hist, 1, dtype=torch.int32) - hist):
            want_k, want_p = cs.onesweep_pass(want_k, want_p, g, base[: 1 << len(g)])
        check_same("onesweep_pass", f"one call n={n} keys={kd} bits={pos} payloads={ns}", [got_k, *got_p],
                   [want_k, *want_p])
        del keys, pays, got_k, got_p, want_k, want_p, hist
    k3_cases = 0
    for n in (1, 2, 1000, cs.CTA_MAX, cs.CTA_MAX + 1, 10000, 24576, 24577, 32768, 49153, 65535, cs.SINGLE_TILE_MAX):
        for kd in ("uniform", "constant", "mod3"):
            for pos in (tuple(range(32)), tuple(range(12)), tuple(range(24, 32)), (31, 0, 17, 5, 9)):
                for ns in (0, 1, 7):
                    keys = words(n, kd)
                    pays = [torch.arange(n, dtype=torch.int32, device=dev)] + [words(n, "uniform") for _ in range(ns - 1)]
                    pays = pays[:ns]
                    got = cs.sort_single_tile(keys, pays, pos)
                    want = cs.sort_single_tile_ref(keys, pays, pos)
                    check_same("sort_single_tile", f"n={n} keys={kd} bits={pos} payloads={ns}",
                               [got[0], *got[1]], [want[0], *want[1]])
                    k3_cases += 1
    # every CTA count that holds the input, one CTA and every cluster,
    # against the plain version
    for n in (cs.SLICE_MAX, 49153, cs.SINGLE_TILE_MAX):
        for ctas in range(1, cs.MAX_CLUSTER + 1):
            if cs.single_tile_slice(n, ctas) > cs.SLICE_MAX:
                continue
            for pos in (tuple(range(32)), (31, 0, 17, 5, 9)):
                for ns in (1, 7):
                    keys = words(n, "uniform")
                    pays = [torch.arange(n, dtype=torch.int32, device=dev)] + [words(n, "uniform") for _ in range(ns - 1)]
                    got = cs.sort_single_tile(keys, pays, pos, ctas=ctas)
                    want = cs.sort_single_tile_ref(keys, pays, pos)
                    check_same("sort_single_tile", f"n={n} ctas={ctas} bits={pos} payloads={ns}",
                               [got[0], *got[1]], [want[0], *want[1]])
                    k3_cases += 1
    # too few CTAs for the input (slices over SLICE_MAX): the C entry
    # refuses the launch and the wrapper's error check raises
    keys = words(cs.SINGLE_TILE_MAX, "uniform")
    before = cs.launch_counts()["sort_single_tile"]
    try:
        cs._launch("glu_sort_single_tile", dev, cs._pointers([keys]), cs._pointers([torch.empty_like(keys)]), 1,
                   keys.numel(), *cs._single_tile_plan(tuple(range(32)))[1], 2)
    except glu_tpu_torch.GluError as e:
        print(f"K3 on 2 CTAs of {keys.numel()} elements (slices over SLICE_MAX): refused, {e}")
    else:
        raise AssertionError("K3 launched on 2 CTAs for 65,536 elements")
    if cs.launch_counts()["sort_single_tile"] != before:
        raise AssertionError("a refused K3 launch was counted")
    print(f"K3 clusters the card holds at once (cudaOccupancyMaxActiveClusters): "
          f"{ {c: cs._sort_lib().glu_sort_single_tile_clusters(c) for c in range(2, cs.MAX_CLUSTER + 1)} }")
    del keys
    torch.cuda.synchronize()
    print(f"kernels vs plain versions: bit-identical, max_abs_err {max_err} "
          f"({len(pass_cases)} histogram/onesweep cases, {len(fused_cases)} one-call sorts against the per-pass "
          f"wrappers, {k3_cases} K3 cases, {time.perf_counter() - t0:.1f} s)")

    # -- 4. the main path, bit for bit against torch.sort -----------------------
    def as_u32(w: torch.Tensor) -> torch.Tensor:
        return w.view(torch.uint32)

    def first_mismatch(a: torch.Tensor, b: torch.Tensor):
        diff = (a.view(torch.int32) != b.view(torch.int32)).nonzero()
        return int(diff[0]) if diff.numel() else None

    cases = [
        ("2^28 uniform", MAIN_N, "uniform", 0),
        ("100000007 uniform", 100_000_007, "uniform", 0),
        ("2^24 uniform num_steps=3", 1 << 24, "uniform", 3),
        ("2^24 constant", 1 << 24, "constant", 0),
        ("2^24 presorted", 1 << 24, "presorted", 0),
        ("2^24 reversed", 1 << 24, "reversed", 0),
        ("10000 uniform (single tile)", 10_000, "uniform", 0),
        ("CTA_MAX+1 uniform (single tile, a cluster)", cs.CTA_MAX + 1, "uniform", 0),
        ("SINGLE_TILE_MAX uniform (single tile)", cs.SINGLE_TILE_MAX, "uniform", 0),
        ("SINGLE_TILE_MAX+1 uniform", cs.SINGLE_TILE_MAX + 1, "uniform", 0),
        ("n=0", 0, "uniform", 0),
        ("n=1", 1, "uniform", 0),
        ("n=2", 2, "uniform", 0),
    ]
    cs.reset_launch_counts()
    per_case = {}
    for label, n, kd, steps in cases:
        keys = as_u32(words(n, kd))
        values = as_u32(torch.arange(n, dtype=torch.int32, device=dev))
        before = cs.launch_counts()
        out_k, out_v = glu_tpu_torch.radix_sort(keys, values, steps, backend="cuda")
        torch.cuda.synchronize()
        after = cs.launch_counts()
        per_case[label] = {k: after[k] - before[k] for k in after}
        ref_k, ref_v = glu_tpu_torch.radix_sort(keys, values, steps, backend="torch")
        for what, got, want in (("keys", out_k, ref_k), ("values", out_v, ref_v)):
            if got.dtype != torch.uint32 or got.shape != (n,):
                raise AssertionError(f"{label}: {what} came back as {got.dtype} {tuple(got.shape)}")
            bad = first_mismatch(got, want)
            if bad is not None:
                print(f"MISMATCH {label}: {what} first differ at index {bad}")
                raise AssertionError(f"{label}: {what} differ from torch.sort")
        if n and n <= 10_000:  # a host reference on the small input
            import numpy as np

            k_host = glu_tpu_torch.to_numpy(keys)
            order = np.argsort(k_host, kind="stable")
            assert (glu_tpu_torch.to_numpy(out_k) == k_host[order]).all(), label
            assert (glu_tpu_torch.to_numpy(out_v) == order).all(), label
        print(f"main path {label}: bit-identical to torch.sort (stable), launches {per_case[label]}")
        del keys, values, out_k, out_v, ref_k, ref_v
    launches = cs.launch_counts()

    # -- 5. launch counts -----------------------------------------------------
    want_launches = {"2^28 uniform": (1, 4, 0), "2^24 uniform num_steps=3": (1, 2, 0),
                     "10000 uniform (single tile)": (0, 0, 1), "CTA_MAX+1 uniform (single tile, a cluster)": (0, 0, 1),
                     "SINGLE_TILE_MAX uniform (single tile)": (0, 0, 1), "SINGLE_TILE_MAX+1 uniform": (1, 4, 0)}
    for label, want in want_launches.items():
        got = tuple(per_case[label][k] for k in ("digit_histograms", "onesweep_pass", "sort_single_tile"))
        if got != want:
            raise AssertionError(f"{label} launched digit_histograms/onesweep_pass/sort_single_tile {got}, want {want}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    print(f"launch counts over the main path: {launches}")

    # -- 6. the sort variants at full width --------------------------------------
    def median_ms(fn, reps: int = REPS) -> float:
        fn()  # warm-up
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    def host_us(fn, reps: int = 50) -> float:
        """Host time per call: from the call to its return, the card idle
        before each call (median)."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return sorted(times)[reps // 2] * 1e6

    def back_to_back_ms(fn, launches: int = 200) -> float:
        """Device ms a call of fn over `launches` calls queued back to back
        between two CUDA events, for a kernel whose host time is shorter
        than its device time (K3's): the kernel alone, where the profiler
        sees none."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / launches

    def k3_kernel_text(fn) -> str:
        """K3's kernel alone: the profiler's median of 20 traced calls, and
        the device ms a call of 200 queued back to back."""
        traced = _kernel_device_ms(torch, fn)
        return (f"{'not measured' if traced is None else f'{traced:.4f} ms'} by the profiler (median of 20 "
                f"launches), {back_to_back_ms(fn):.4f} ms a launch of 200 back to back")

    def turns(kernel_fn, plain_fn, reps: int = REPS):
        """(kernel ms, plain ms): the lower of two medians each, measured in
        turns plain, kernel, kernel, plain."""
        p_ms = [median_ms(plain_fn, reps)]
        k_ms = [median_ms(kernel_fn, reps), median_ms(kernel_fn, reps)]
        p_ms.append(median_ms(plain_fn, reps))
        return min(k_ms), min(p_ms)

    tag = f"[{gpu}]"
    t0 = time.perf_counter()

    def iota(n: int) -> torch.Tensor:
        return as_u32(torch.arange(n, dtype=torch.int32, device=dev))

    def f32_specials(n: int) -> torch.Tensor:
        """Normal floats with +-0.0, +-inf and NaNs of both signs sprinkled in."""
        k = torch.randn(n, device=dev, generator=gen)
        patterns = (0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF)
        specials = torch.tensor([p - (p >> 31 << 32) for p in patterns], dtype=torch.int32, device=dev)
        at = torch.randint(0, n, (max(n // 1000, 64),), device=dev, generator=gen)
        k.view(torch.int32)[at] = specials[torch.randint(0, specials.numel(), at.shape, device=dev, generator=gen)]
        return k

    def u64_duplicates(n: int) -> torch.Tensor:
        """Keys drawn from n / 4 distinct u64 words, half of them >= 2**63."""
        distinct = torch.randint(-(2**63), 2**63 - 1, (n // 4,), dtype=torch.int64, device=dev, generator=gen)
        return distinct[torch.randint(0, n // 4, (n,), device=dev, generator=gen)].view(torch.uint64)

    def uneven_offsets(n: int, segments: int) -> torch.Tensor:
        cuts = torch.sort(torch.randint(0, n + 1, (segments - 1,), device=dev, generator=gen)).values
        return torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), n)])

    def flat(out) -> list:
        return [t for o in (out if isinstance(out, tuple) else (out,)) for t in (o if isinstance(o, tuple) else (o,))]

    def int_bits(t: torch.Tensor) -> torch.Tensor:
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32)

    small_n = 10_000
    u32_at = lambda n: as_u32(words(n, "uniform"))  # noqa: E731
    variants = [  # label, function, full size, n -> (args, keywords), launches at full size and at small_n
        ("radix_sort_keys", "radix_sort_keys", MAIN_N, lambda n: ((u32_at(n),), {}), (1, 4, 0), (0, 0, 1)),
        ("radix_argsort descending, keys & 0xFFFFF", "radix_argsort", MAIN_N,
         lambda n: ((as_u32(words(n, "uniform") & 0xFFFFF),), {"descending": True}), (1, 4, 0), (0, 0, 1)),
        ("radix_sort_f32 with specials", "radix_sort_f32", MAIN_N, lambda n: ((f32_specials(n), iota(n)), {}),
         (1, 4, 0), (0, 0, 1)),
        ("radix_sort_i32", "radix_sort_i32", MAIN_N, lambda n: ((words(n, "uniform"), iota(n)), {}),
         (1, 4, 0), (0, 0, 1)),
        ('radix_sort bits="auto", keys < 2**10', "radix_sort", MAIN_N,
         lambda n: ((as_u32(words(n, "uniform") & 0x3FF), iota(n)), {"bits": "auto"}), (2, 2, 0), (1, 0, 1)),
        ("radix_sort bits=(0, 3, 9, 17, 31)", "radix_sort", MAIN_N,
         lambda n: ((u32_at(n), iota(n)), {"bits": (0, 3, 9, 17, 31)}), (1, 1, 0), (0, 0, 1)),
        ("radix_sort_u64 with duplicates", "radix_sort_u64", MAIN_N, lambda n: ((u64_duplicates(n), iota(n)), {}),
         (2, 8, 0), (0, 0, 2)),
        ("radix_sort_segmented, 4096 uneven offsets", "radix_sort_segmented", MAIN_N,
         lambda n: ((u32_at(n), iota(n)), {"offsets": uneven_offsets(n, 4096)}), (2, 6, 0), (0, 0, 2)),
        ("radix_sort_segmented, 4096 partitions (100 at small_n)", "radix_sort_segmented", MAIN_N,
         lambda n: ((u32_at(n), iota(n)), {"num_partitions": 4096 if n == MAIN_N else 100}), (2, 6, 0), (0, 0, 2)),
        ("radix_sort_multi, 7 payloads", "radix_sort_multi", 1 << 24,
         lambda n: ((u32_at(n), [iota(n)] + [u32_at(n) for _ in range(6)]), {}), (1, 4, 0), (0, 0, 1)),
        ("radix_sort_multi, 9 payloads", "radix_sort_multi", 1 << 24,
         lambda n: ((u32_at(n), [iota(n)] + [u32_at(n) for _ in range(8)]), {}), (1, 4, 0), (0, 0, 1)),
    ]
    kernel_order = ("digit_histograms", "onesweep_pass", "sort_single_tile")
    variant_launches = dict.fromkeys(kernel_order, 0)
    variant_times = []
    for label, fn_name, full_n, make, want_full, want_small in variants:
        fn = getattr(glu_tpu_torch, fn_name)
        for n, want in ((full_n, want_full), (small_n, want_small)):
            args, kw = make(n)
            torch.cuda.synchronize()
            cs.reset_launch_counts()
            got = flat(fn(*args, backend="cuda", **kw))
            torch.cuda.synchronize()
            counts = cs.launch_counts()
            ran = tuple(counts[k] for k in kernel_order)
            if ran != want:
                raise AssertionError(f"{label} n={n}: launched histogram/onesweep/K3 {ran}, want {want}")
            for k in kernel_order:
                variant_launches[k] += counts[k]
            ref = flat(fn(*args, backend="torch", **kw))
            if len(got) != len(ref):
                raise AssertionError(f"{label} n={n}: {len(got)} outputs, the torch backend {len(ref)}")
            for i, (g, r) in enumerate(zip(got, ref)):
                if g.dtype != r.dtype or g.shape != r.shape or not g.is_cuda:
                    raise AssertionError(f"{label} n={n} output {i}: {g.dtype} {tuple(g.shape)} on {g.device}, "
                                         f"want {r.dtype} {tuple(r.shape)}")
                bad = first_mismatch(int_bits(g), int_bits(r))
                if bad is not None:
                    raise AssertionError(f"{label} n={n} output {i}: differs from backend torch at index {bad}")
            print(f"sort variant {label}, n={n}: bit-identical to backend torch, launches "
                  f"histogram/onesweep/K3 {ran}")
            if n == full_n:
                cuda_ms, torch_ms = turns(lambda: fn(*args, backend="cuda", **kw),
                                          lambda: fn(*args, backend="torch", **kw))
                variant_times.append(f"time {label} ({n} pairs): backend cuda {cuda_ms:.3f} ms, "
                                     f"backend torch {torch_ms:.3f} ms {tag}")
                if fn_name != "radix_sort_i32" and n == MAIN_N and "bits=(" not in label:
                    for line in _profile_kernels(torch, lambda: fn(*args, backend="cuda", **kw)):
                        variant_times.append(f"profile {label} ({n} pairs): {line} {tag}")
            del args, kw, got, ref
    for line in variant_times:
        print(line)
    for k in kernel_order:
        launches[k] += variant_launches[k]
    print(f"sort variants: {2 * len(variants)} calls bit-identical to backend torch, launches {variant_launches} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 7. K4 and K5 against their plain versions -----------------------------
    import numpy as np

    from glu_tpu_torch import DataType, ReduceOperator as Op
    from glu_tpu_torch.ops import _cuda_reduce as cr
    from glu_tpu_torch.ops import _cuda_scan as csc

    t0 = time.perf_counter()

    def fold_input(dtype, op, shape) -> torch.Tensor:
        """Values that keep every prefix meaningful: odd integer factors for
        MUL, float factors near 1, positive float addends (no
        cancellation), and a NaN in row 0 for float MIN/MAX."""
        if not dtype.is_floating_point:
            w = torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=dev, generator=gen)
            w = w | 1 if op == Op.MUL else w
            return w.view(torch.uint32) if dtype == torch.uint32 else w
        if op == Op.SUM:
            return torch.rand(shape, dtype=dtype, device=dev, generator=gen)
        if op == Op.MUL:
            return torch.exp(torch.randn(shape, dtype=dtype, device=dev, generator=gen) * 1e-3)
        x = torch.rand(shape, dtype=dtype, device=dev, generator=gen) * 2 - 1
        x[0, shape[1] // 3] = float("nan")
        return x

    def as_i64(t: torch.Tensor) -> torch.Tensor:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF if t.dtype == torch.uint32 else t.to(torch.int64)

    max_err.update({"exclusive_scan": 0.0, "reduce": 0.0})

    def check_close(name: str, label: str, got: torch.Tensor, want: torch.Tensor) -> None:
        """Integers bit for bit; floats at FLOAT_TOL, NaN where want has it."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {label}: {got.dtype} {tuple(got.shape)} != {want.dtype} {tuple(want.shape)}")
        if not got.numel():
            return
        if got.dtype.is_floating_point:
            if not torch.equal(torch.isnan(got), torch.isnan(want)):
                raise AssertionError(f"{name} {label}: NaN in other places than its plain version")
            ok = ~torch.isnan(want)
            g, w = got[ok].double(), want[ok].double()
            diff = (g - w).abs()
            err = float(diff.max()) if diff.numel() else 0.0
            bad = bool((diff > FLOAT_TOL["atol"] + FLOAT_TOL["rtol"] * w.abs()).any())
        else:
            err = float((as_i64(got) - as_i64(want)).abs().max())
            bad = err != 0
        max_err[name] = max(max_err[name], err)
        if bad:
            raise AssertionError(f"{name} {label}: differs from its plain version (max abs err {err})")

    # ragged, one tile, 100 partitions of 1000, the UVEC4 layout (C = 4
    # partitions), the sort's [digit][tile] table of a 2^28 sort
    fold_shapes = [(1, 1), (1, 4097), (1, 1_000_003), (100, 1000), (4, 65_539), (16, MAIN_N // cs.TILE)]
    fold_dtypes = (torch.int32, torch.uint32, torch.float32, torch.float64)
    fold_cases = [(shape, dt, op) for shape in fold_shapes for dt in fold_dtypes for op in Op]
    fold_cases.append(((1, MAIN_N), torch.uint32, Op.SUM))  # the main path's shape
    fold_cases.append(((1, 1 << 26), torch.float64, Op.SUM))  # K4's 8-byte status over 8K tiles
    def reduce_once(label: str, x: torch.Tensor, op) -> torch.Tensor:
        """K5 against its plain version, in one launch."""
        before = cr.reduce_launches
        got = cr.reduce_partitions(x, op)
        if cr.reduce_launches - before != 1:
            raise AssertionError(f"reduce {label}: {cr.reduce_launches - before} launches, want 1")
        check_close("reduce", label, got, cr.reduce_partitions_ref(x, op))
        return got

    for shape, dt, op in fold_cases:
        if dt.is_floating_point and op == Op.MUL and shape[1] > 100_003:
            shape = (shape[0], 100_003)  # a long float product drifts by its rounding
        label = f"{op.name} {dt} {shape}"
        x = fold_input(dt, op, shape)
        reduce_once(label, x, op)
        check_close("exclusive_scan", label, csc.exclusive_scan_partitions(x, op),
                    csc.exclusive_scan_partitions_ref(x, op))
        del x
    # K5 alone: rows of 2- and 4-vectors, rows off a 16-byte boundary (1-wide
    # loads), more rows than MAX_CTAS (one CTA a row, no ticket), and the
    # main path's vector streams as one (1, N, C) row
    vec_cases = [(shape, dt, op, False) for shape in ((1, 100_003, 2), (3, 4_097, 4), (1_100, 5_000), (2_000, 300, 4))
                 for dt in fold_dtypes for op in Op]
    vec_cases += [(shape, dt, op, True) for shape in ((1, 100_003, 4), (2, 5_001, 2)) for dt in fold_dtypes for op in Op]
    vec_cases += [((1, *VEC_U32), torch.uint32, Op.SUM, False), ((1, *VEC_F64), torch.float64, Op.MIN, False)]
    for shape, dt, op, unaligned in vec_cases:
        label = f"{op.name} {dt} {shape}{' unaligned' if unaligned else ''}"
        if unaligned:
            x = fold_input(dt, op, (1, int(np.prod(shape)) + 1)).view(-1)[1:].view(shape)
            assert x.data_ptr() % 16
        else:
            x = fold_input(dt, op, shape)
        reduce_once(label, x, op)
        del x
    # which tile a look-back stops at, and which CTA of a row folds K5's
    # partials, depend on timing; the floats must not
    rerun_cases = [("exclusive_scan", shape, dt, op) for shape in ((1, 1 << 22), (64, 3 * csc.TILE + 5))
                   for dt, op in ((torch.float32, Op.SUM), (torch.float64, Op.MUL))]
    rerun_cases += [("reduce", shape, dt, op) for shape in ((1, 1 << 22), (1, 1 << 20, 4))
                    for dt, op in ((torch.float32, Op.SUM), (torch.float64, Op.MUL))]
    kernel_of = {"exclusive_scan": csc.exclusive_scan_partitions, "reduce": cr.reduce_partitions}
    for name, shape, dt, op in rerun_cases:
        x = fold_input(dt, op, shape)
        first = kernel_of[name](x, op).view(torch.int8)
        for _ in range(4):
            if not torch.equal(kernel_of[name](x, op).view(torch.int8), first):
                raise AssertionError(f"{name} {op.name} {dt} {shape}: differs from run to run")
        del x, first
    torch.cuda.synchronize()
    print(f"K4/K5 vs plain versions: {len(fold_cases)} cases each and {len(vec_cases)} more of K5 (one launch "
          f"each), integers bit-identical, floats within rtol {FLOAT_TOL['rtol']} atol {FLOAT_TOL['atol']}; "
          f"max_abs_err exclusive_scan {max_err['exclusive_scan']!r} reduce {max_err['reduce']!r}; "
          f"bit-identical over 5 runs in {len(rerun_cases)} float cases ({time.perf_counter() - t0:.1f} s)")

    # -- 8. the scan and reduce main path at full width -------------------------
    def slice_call(label: str, fn, want: tuple):
        """Run fn on the card; its K4 and K5 launches must be `want`."""
        before = (csc.scan_launches, cr.reduce_launches)
        out = fn()
        torch.cuda.synchronize()
        got = (csc.scan_launches - before[0], cr.reduce_launches - before[1])
        if got != want:
            raise AssertionError(f"{label}: launched K4/K5 {got} times, want {want}")
        return out

    def check_exact(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if got.shape != want.shape or got.dtype != want.dtype or got.device != want.device:
            raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} on {got.device}")
        same = torch.equal(got.view(torch.int32), want.view(torch.int32)) if got.dtype == torch.uint32 \
            else torch.equal(got, want)
        if not same:
            raise AssertionError(f"{label}: differs from its reference")
        print(f"main path {label}: identical to its reference")

    u = as_u32(words(MAIN_N, "uniform"))
    csc.reset_launch_counts()
    cr.reset_launch_counts()
    check_exact("exclusive_scan 2^28 u32 SUM", slice_call("exclusive_scan", lambda: glu_tpu_torch.exclusive_scan(u, backend="cuda"), (1, 0)),
                glu_tpu_torch.exclusive_scan(u, backend="torch"))
    check_exact("inclusive_scan 2^28 u32 SUM", slice_call("inclusive_scan", lambda: glu_tpu_torch.inclusive_scan(u, backend="cuda"), (1, 0)),
                glu_tpu_torch.inclusive_scan(u, backend="torch"))
    check_exact("reduce 2^28 u32 SUM", slice_call("reduce", lambda: glu_tpu_torch.reduce(u, backend="cuda"), (0, 1)),
                glu_tpu_torch.reduce(u, backend="torch"))
    u4 = u.view(VEC_U32)
    f4 = torch.rand(VEC_F64, dtype=torch.float64, device=dev, generator=gen) * 2 - 1
    for label, x, op in (("reduce (2^26, 4) u32 SUM", u4, Op.SUM), ("reduce (2^25, 4) f64 MIN", f4, Op.MIN)):
        torch.cuda.synchronize()
        in_use = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = slice_call(label, lambda: glu_tpu_torch.reduce(x, op, backend="cuda"), (0, 1))
        extra = torch.cuda.max_memory_allocated() - in_use
        if extra >= 1 << 20:
            raise AssertionError(f"{label}: allocated {extra} bytes beyond its input, a copy of it")
        check_exact(label, got, glu_tpu_torch.reduce(x, op, backend="torch"))
        print(f"main path {label}: {extra} bytes allocated beyond the {x.numel() * x.element_size()}-byte input")
    del u, u4, f4, got
    f = torch.rand(MAIN_N, dtype=torch.float32, device=dev, generator=gen)
    check_exact("reduce 2^28 f32 MAX", slice_call("reduce f32", lambda: glu_tpu_torch.reduce(f, Op.MAX, backend="cuda"), (0, 1)),
                torch.amax(f))
    del f
    g = torch.rand(1 << 24, dtype=torch.float32, device=dev, generator=gen)
    exc = slice_call("exclusive_scan f32", lambda: glu_tpu_torch.exclusive_scan(g, backend="cuda"), (1, 0))
    exact = torch.cumsum(g.double(), 0) - g.double()
    err = float((exc.double() - exact).abs().max())
    if not torch.allclose(exc.double(), exact, **FLOAT_TOL):
        raise AssertionError(f"exclusive_scan 2^24 f32: off the f64 cumsum (max abs err {err})")
    print(f"main path exclusive_scan 2^24 f32 SUM: within rtol {FLOAT_TOL['rtol']} atol {FLOAT_TOL['atol']} "
          f"of an f64 torch.cumsum (max abs err {err!r}, largest prefix {float(exact[-1])!r})")
    del g, exc, exact
    n_seg = 1 << 24
    v = as_u32(words(n_seg, "uniform"))
    cuts = torch.sort(torch.randint(0, n_seg + 1, (9_999,), device=dev, generator=gen)).values
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cuts, torch.full((1,), n_seg, device=dev)])
    seg = slice_call("segmented_reduce", lambda: glu_tpu_torch.segmented_reduce(v, offs, backend="cuda"), (1, 0))
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(as_i64(v), 0)])
    want_seg = ((prefix[offs[1:]] - prefix[offs[:-1]]) & 0xFFFFFFFF).to(torch.int64)
    if not torch.equal(as_i64(seg), want_seg):
        raise AssertionError("segmented_reduce 2^24 u32: differs from the int64 prefix-sum reference")
    check_exact("segmented_reduce 2^24 u32, 10^4 uneven segments", seg,
                glu_tpu_torch.segmented_reduce(v, offs, backend="torch"))
    del v, offs, prefix, seg
    host = np.random.default_rng(SEED).integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    buf = glu_tpu_torch.DeviceBuffer(host)  # the default device: the card
    if buf.device.type != "cuda":
        raise AssertionError(f"DeviceBuffer(numpy) went to {buf.device}, not the card")
    scanned = slice_call("BlellochScan", lambda: glu_tpu_torch.BlellochScan(DataType.UINT)(buf, 1 << 18, 4, backend="cuda"),
                         (1, 0))
    want_host = np.concatenate([np.cumsum(p, dtype=np.uint32) - p for p in host.reshape(4, -1)])
    if not (buf.get_data() == want_host).all() or scanned.data_ptr() != buf.data.data_ptr():
        raise AssertionError("BlellochScan on a DeviceBuffer: not the numpy exclusive scan, in place")
    print("main path BlellochScan(UINT) 4 x 2^18 on a default-device DeviceBuffer: in place, identical to numpy")
    buf = glu_tpu_torch.DeviceBuffer(host)
    total = slice_call("Reduce", lambda: glu_tpu_torch.Reduce(DataType.UINT, Op.SUM)(buf, 1 << 20, backend="cuda"),
                       (0, 1))
    if not int(total) == int(buf.get_data()[0]) == int(host.sum(dtype=np.uint32)):
        raise AssertionError("Reduce on a DeviceBuffer: not the numpy sum at buffer[0]")
    print("main path Reduce(UINT, SUM) 2^20 on a default-device DeviceBuffer: buffer[0] is the numpy sum")
    del buf
    fold_launches = {"exclusive_scan": csc.scan_launches, "reduce": cr.reduce_launches}
    if min(fold_launches.values()) < 1:
        raise AssertionError(f"a kernel of the scan/reduce path never launched: {fold_launches}")
    print(f"launch counts over the scan/reduce path: {fold_launches}")
    launches.update(fold_launches)

    # -- 9. timings, for the record ----------------------------------------------
    keys = as_u32(words(MAIN_N, "uniform"))
    values = as_u32(torch.arange(MAIN_N, dtype=torch.int32, device=dev))
    sort_ms, torch_ms = turns(lambda: glu_tpu_torch.radix_sort(keys, values, backend="cuda"),
                              lambda: glu_tpu_torch.radix_sort(keys, values, backend="torch"))
    print(f"time radix_sort 2^28 pairs: port {sort_ms:.3f} ms = {MAIN_N / sort_ms / 1e3:.2f} M pairs/s; "
          f"torch.sort(stable)+gather {torch_ms:.3f} ms = {MAIN_N / torch_ms / 1e3:.2f} M pairs/s {tag}")
    for line in _profile_kernels(torch, lambda: glu_tpu_torch.radix_sort(keys, values, backend="cuda")):
        print(f"profile radix_sort (2^28 pairs): {line} {tag}")
    kw, vw = keys.view(torch.int32), values.view(torch.int32)
    del keys, values
    pos = tuple(range(8))
    hist = cs.digit_histograms(kw, hist_groups)
    base = (torch.cumsum(hist, 1, dtype=torch.int32) - hist)[0]
    timing = {}
    timing["digit_histograms"] = turns(lambda: cs.digit_histograms(kw, hist_groups),
                                       lambda: cs.digit_histograms_ref(kw, hist_groups))
    timing["onesweep_pass"] = turns(lambda: cs.onesweep_pass(kw, [vw], pos, base),
                                    lambda: cs.onesweep_pass_ref(kw, [vw], pos, base))
    del hist, base, kw, vw
    full = tuple(range(32))

    def sort_and_gather(k, v):
        r = torch.sort(k, stable=True)
        return r.values, v[r.indices]

    library = {"digit_histograms": None, "onesweep_pass": None}
    for n in (cs.CTA_MAX, K3_N, cs.SINGLE_TILE_MAX):  # K3: the kernel alone, its wrapper, the host, the entry point
        sk, sv = words(n, "uniform"), torch.arange(n, dtype=torch.int32, device=dev)
        k3 = lambda: cs.sort_single_tile(sk, [sv], full)  # noqa: E731
        k3_ms, plain_ms = turns(k3, lambda: cs.sort_single_tile_ref(sk, [sv], full), reps=20)
        api_ms = median_ms(lambda: glu_tpu_torch.radix_sort(as_u32(sk), as_u32(sv), backend="cuda"), reps=20)
        lib_ms = median_ms(lambda: sort_and_gather(sk, sv), reps=20)
        print(f"time sort_single_tile ({n} pairs, 32 bits, {cs.single_tile_ctas(n)} CTAs): wrapper {k3_ms:.4f} ms, "
              f"plain torch {plain_ms:.4f} ms, host {host_us(k3):.1f} us per call, radix_sort {api_ms:.4f} ms, "
              f"torch.sort(stable)+gather {lib_ms:.4f} ms {tag}")
        print(f"time sort_single_tile ({n} pairs, 32 bits): kernel {k3_kernel_text(k3)} {tag}")
        if n == K3_N:
            timing["sort_single_tile"], library["sort_single_tile"] = (k3_ms, plain_ms), lib_ms
        del sk, sv
    for ctas in K3_CTAS:  # K3 on each CTA count: the wrapper, then the kernel alone
        n = next(m for m in (cs.SINGLE_TILE_MAX, 49152, 32768, 16384) if cs.single_tile_slice(m, ctas) <= cs.SLICE_MAX)
        sk, sv = words(n, "uniform"), torch.arange(n, dtype=torch.int32, device=dev)
        k3 = lambda: cs.sort_single_tile(sk, [sv], full, ctas=ctas)  # noqa: E731
        print(f"time sort_single_tile on {ctas} CTAs ({n} pairs, 32 bits): wrapper {median_ms(k3, reps=20):.4f} ms, "
              f"kernel {k3_kernel_text(k3)} {tag}")
        del sk, sv

    def onesweep_path(k, v):
        """The engine's multi-tile path (1 histogram + 4 passes) at any n,
        through the per-pass wrappers (radix_sort runs it as one call)."""
        hist = cs.digit_histograms(k, hist_groups)
        for g, base in zip(hist_groups, torch.cumsum(hist, 1, dtype=torch.int32) - hist):
            k, (v,) = cs.onesweep_pass(k, [v], g, base)
        return k, v

    for n in CROSSOVER_N:  # where K3 stops beating the onesweep path
        ck, cv = words(n, "uniform"), torch.arange(n, dtype=torch.int32, device=dev)
        k3_text = (f"{median_ms(lambda: cs.sort_single_tile(ck, [cv], full), reps=20):.4f}"
                   if n <= cs.SINGLE_TILE_MAX else "- (above its limit)")
        print(f"crossover n={n} (32-bit pairs, ms): sort_single_tile {k3_text}, histogram + onesweep per pass "
              f"{median_ms(lambda: onesweep_path(ck, cv), reps=20):.4f}, onesweep_sort (one call) "
              f"{median_ms(lambda: cs.onesweep_sort(ck, [cv], full), reps=20):.4f}, torch.sort(stable)+gather "
              f"{median_ms(lambda: sort_and_gather(ck, cv), reps=20):.4f}, radix_sort backend cuda "
              f"{median_ms(lambda: glu_tpu_torch.radix_sort(as_u32(ck), as_u32(cv), backend='cuda'), reps=20):.4f}"
              f", routed {median_ms(lambda: glu_tpu_torch.radix_sort(as_u32(ck), as_u32(cv)), reps=20):.4f} {tag}")
        del ck, cv
    # K3 at its limit against the multi-tile engine's one call at the same
    # n and torch.sort, the way phase 10 times them: one call at a time in
    # turns, each after an L2 flush (the card idle and its caches cold)
    from glu_tpu_torch.ops import router

    flush = router.l2_flush(dev)
    ck, cv = words(cs.SINGLE_TILE_MAX, "uniform"), torch.arange(cs.SINGLE_TILE_MAX, dtype=torch.int32, device=dev)
    cold = {"sort_single_tile": lambda: cs.sort_single_tile(ck, [cv], full),
            "onesweep_sort": lambda: cs.onesweep_sort(ck, [cv], full),
            "torch.sort(stable)+gather": lambda: sort_and_gather(ck, cv)}
    cold_ms = {name: [] for name in cold}
    for fn in cold.values():
        fn()
    for _ in range(100):
        for name, fn in cold.items():
            flush()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            cold_ms[name].append(start.elapsed_time(end))
    print(f"time {cs.SINGLE_TILE_MAX} pairs after an L2 flush, in turns (medians of 100, ms): "
          + ", ".join(f"{name} {sorted(t)[50]:.4f}" for name, t in cold_ms.items()) + f" {tag}")
    del ck, cv, flush
    ck, cv = words(MAIN_N, "uniform"), torch.arange(MAIN_N, dtype=torch.int32, device=dev)
    one_ms, per_ms = turns(lambda: cs.onesweep_sort(ck, [cv], full), lambda: onesweep_path(ck, cv))
    print(f"time the 2^28-pair multi-tile sort: one library call (onesweep_sort) {one_ms:.4f} ms, the same "
          f"launches through the per-pass wrappers {per_ms:.4f} ms, in turns {tag}")
    del ck, cv
    pair_bytes = MAIN_N * 2 * 4
    bounds = {  # the function's bytes: the pass's status words are the design's, not counted
        "digit_histograms": _bound(MAIN_N * 4 + len(hist_groups) * cs.BINS * 4, len(hist_groups) * MAIN_N),
        "onesweep_pass": _bound(2 * pair_bytes + cs.BINS * 4, MAIN_N),
        "sort_single_tile": _bound(2 * K3_N * 2 * 4, len(hist_groups) * K3_N),  # 4 passes of 8 bits
    }
    shapes = {"digit_histograms": "2^28 keys, 4 passes of 8 bits", "onesweep_pass": "2^28 pairs, one 8-bit pass",
              "sort_single_tile": f"{K3_N} pairs, 32 bits"}
    for name, (k_ms, p_ms) in timing.items():
        lib_text = "" if library[name] is None else f", torch.sort(stable)+gather {library[name]:.4f} ms"
        print(f"time {name} ({shapes[name]}): kernel {k_ms:.4f} ms, plain torch {p_ms:.4f} ms{lib_text}, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) {tag}")

    u = as_u32(words(MAIN_N, "uniform"))
    u2, w32 = u.view(1, MAIN_N), u.view(torch.int32)
    timing["exclusive_scan"] = turns(lambda: csc.exclusive_scan_partitions(u2, Op.SUM),
                                     lambda: csc.exclusive_scan_partitions_ref(u2, Op.SUM), reps=FOLD_REPS)
    library["exclusive_scan"] = median_ms(lambda: torch.cumsum(w32, 0, dtype=torch.int32), reps=FOLD_REPS)
    timing["reduce"] = turns(lambda: cr.reduce_partitions(u2, Op.SUM),
                             lambda: cr.reduce_partitions_ref(u2, Op.SUM), reps=FOLD_REPS)
    library["reduce"] = median_ms(lambda: torch.sum(w32, dtype=torch.int32), reps=FOLD_REPS)
    bounds["exclusive_scan"] = _bound(2 * MAIN_N * 4, MAIN_N)
    bounds["reduce"] = _bound(MAIN_N * 4 + 4, MAIN_N)
    for name, call in (("exclusive_scan", "torch.cumsum(int32)"), ("reduce", "torch.sum(int32)")):
        k_ms, p_ms = timing[name]
        print(f"time {name} (2^28 u32 SUM): kernel {k_ms:.4f} ms = {MAIN_N * 4 / k_ms / 1e6:.1f} GB/s of input, "
              f"plain torch {p_ms:.4f} ms, {call} {library[name]:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) {tag}")
    api = {
        name: turns(lambda fn=fn: fn(u, backend="cuda"), lambda fn=fn: fn(u, backend="torch"), reps=FOLD_REPS)
        for name, fn in (("exclusive_scan", glu_tpu_torch.exclusive_scan),
                         ("inclusive_scan", glu_tpu_torch.inclusive_scan), ("reduce", glu_tpu_torch.reduce))
    }
    for name, (k_ms, t_ms) in api.items():
        print(f"time glu_tpu_torch.{name} (2^28 u32 SUM): backend cuda {k_ms:.4f} ms, backend torch {t_ms:.4f} ms {tag}")
    for label, fn in (("K5 wrapper reduce_partitions (1, 2^28) u32 SUM", lambda: cr.reduce_partitions(u2, Op.SUM)),
                      ("glu_tpu_torch.reduce 2^28 u32 SUM", lambda: glu_tpu_torch.reduce(u, backend="cuda")),
                      ("torch.sum(int32) 2^28", lambda: torch.sum(w32, dtype=torch.int32))):
        print(f"host {label}: {host_us(fn):.2f} us per call {tag}")
    for label, fn in (("exclusive_scan", lambda: csc.exclusive_scan_partitions(u2, Op.SUM)),
                      ("reduce", lambda: cr.reduce_partitions(u2, Op.SUM))):
        for line in _profile_kernels(torch, fn):
            print(f"profile {label} (2^28 u32 SUM): {line} {tag}")
    u4, w4 = u.view(VEC_U32), w32.view(VEC_U32)
    f4 = torch.rand(VEC_F64, dtype=torch.float64, device=dev, generator=gen)
    for label, fn, lib_fn, lib_name in (
            ("(2^26, 4) u32 SUM", lambda: glu_tpu_torch.reduce(u4, backend="cuda"),
             lambda: torch.sum(w4, 0, dtype=torch.int32),
             "torch.sum(x, 0, dtype=int32)"),
            ("(2^25, 4) f64 MIN", lambda: glu_tpu_torch.reduce(f4, Op.MIN, backend="cuda"), lambda: torch.amin(f4, 0),
             "torch.amin(x, 0)")):
        k_ms, t_ms = turns(fn, lib_fn, reps=FOLD_REPS)
        print(f"time glu_tpu_torch.reduce {label}: {k_ms:.4f} ms, {lib_name} {t_ms:.4f} ms, "
              f"bound {bounds['reduce'][0]:.4f} ms (bytes) {tag}")
    for label, fn in (("(2^26, 4) u32 SUM", lambda: glu_tpu_torch.reduce(u4, backend="cuda")),
                      ("(2^25, 4) f64 MIN", lambda: glu_tpu_torch.reduce(f4, Op.MIN, backend="cuda"))):
        for line in _profile_kernels(torch, fn):
            print(f"profile glu_tpu_torch.reduce ({label}): {line} {tag}")
    del u, u2, w32, u4, w4, f4

    # -- 10. the router guard ----------------------------------------------------
    _router_guard(torch, dev, gen, tag)

    # -- 11. the distributed layer -----------------------------------------------
    dist_launches, kb = _distributed_layer(torch, dev, gen, tag, median_ms, turns)
    for name, count in dist_launches.items():
        launches[name] = launches.get(name, 0) + count
    timing["bucket_of"], library["bucket_of"] = (kb["ms"], kb["plain_ms"]), kb["library_ms"]
    bounds["bucket_of"], max_err["bucket_of"] = kb["bound"], kb["max_abs_err"]

    # -- 12. the entry point and the single file -----------------------------------
    for name, count in _entry_and_single_file(torch, tag, turns).items():
        launches[name] += count

    kernels = {  # name: (source, TPU kernel it replaces)
        "digit_histograms": ("glu_tpu_torch/csrc/radix_sort.cu", "glu_tpu/ops/_pallas_sort.py:256"),
        "onesweep_pass": ("glu_tpu_torch/csrc/radix_sort.cu", "glu_tpu/ops/_pallas_sort.py:542"),
        "sort_single_tile": ("glu_tpu_torch/csrc/radix_sort.cu", "glu_tpu/ops/_pallas_sort.py:653"),
        "exclusive_scan": ("glu_tpu_torch/csrc/scan.cu", "glu_tpu/ops/_pallas_scan.py:201"),
        "reduce": ("glu_tpu_torch/csrc/reduce.cu", "glu_tpu/ops/_pallas_reduce.py:110"),
        "bucket_of": ("glu_tpu_torch/csrc/bucket.cu", "glu_tpu/parallel/dist_sort.py:94"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": library[name]}
        for name, (source, replaces) in kernels.items()
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
