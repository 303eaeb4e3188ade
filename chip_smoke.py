#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (glu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which raises (exit code 1) on any failure:
  1. device: a CUDA device is required; prints nvidia-smi's name and power
     limit and the torch/CUDA versions;
  2. build: compiles glu_tpu_torch/csrc/*.cu with nvcc for sm_90a, one nvcc
     per source, all at once;
  3. each sort kernel (group_tiles, scatter_runs, sort_single_tile) against
     its plain torch version on the card, bit for bit, at the main path's
     shape and at small ragged shapes;
  4. the sort's main path: glu_tpu_torch.radix_sort on 2**28 u32 key/value
     pairs and on smaller and edge-case inputs, bit for bit against
     radix_sort(..., backend="torch") (one stable torch.sort) on the card;
  5. launch counts of the sort: the 2**28 sort ran group_tiles and
     scatter_runs 8 times each and sort_single_tile never; the small sort
     ran sort_single_tile;
  6. the scan and reduce kernels (exclusive_scan K4, reduce K5) against
     their plain torch versions on the card, for sum, mul, min and max on
     int32, uint32, float32 and float64, at ragged, partitioned, vector and
     the sort table's shapes and at the main path's 2**28 u32; integers bit
     for bit, floats at rtol 1e-4, atol 1e-3;
  7. the scan and reduce main path: exclusive_scan, inclusive_scan and
     reduce of 2**28 u32, reduce of 2**28 f32 (MAX), exclusive_scan of 2**24
     f32, segmented_reduce of 2**24 u32 over 10**4 uneven segments, and the
     BlellochScan and Reduce classes on DeviceBuffers made on the default
     device, each against backend="torch" or an exact reference; the launch
     counts, set to 0 before and read after, match the design (K4 3
     launches per multi-tile scan, K5 2 per reduce);
  8. timings (CUDA events, medians), for the record only.
The last line is {"ok": true, "device": {...}}; the line before it is
nvidia-smi's line, and the one before that the JSON summary of the kernels.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 20260
MAIN_N = 1 << 28
REPS = 3
FOLD_REPS = 10
# the least time of a kernel: the larger of its bytes over the memory rate
# and its operations over the f32 rate outside the tensor cores (H100 SXM,
# NVIDIA's data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
FLOAT_TOL = dict(rtol=1e-4, atol=1e-3)


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
    arguments (OP, type, vector width), registers, shared memory, spills."""
    import re

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d([a-z][a-z_]*_kernel)(?:ILi(\d)E(\w)(?:Li(\d+)E)?)?", line)
        if entry:
            name = entry.group(1)
            if entry.group(2):  # template <OP, T[, VEC]>: T mangled as i, j, f or d
                name += "<" + ",".join(g for g in entry.groups()[1:] if g) + ">"
        elif "spill" in line:
            spill = "" if " 0 bytes spill stores, 0 bytes spill loads" in line else "; " + line.strip()
        elif "Used" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}{spill}")
            name, spill = None, ""
    return lines


def _profile_kernels(torch, fn) -> list:
    """Device time of each kernel launch of one warm call of fn, in launch
    order, from torch.profiler; "not measured" when it sees no device time."""
    import re
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    lines = []
    for evt in sorted(events, key=lambda e: e.time_range.start):
        us = evt.time_range.elapsed_us()
        if us > 0:
            name = re.search(r"\w+_kernel(<[^>]*>)?", evt.name)
            lines.append(f"{name.group(0) if name else evt.name[:60]} {us / 1e3:.4f} ms")
    return lines or ["kernel device times not measured (the profiler saw no device time)"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

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

    max_err = {"group_tiles": 0, "scatter_runs": 0, "sort_single_tile": 0}

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
    k1k2_cases = [(n_small, kd, pos, ns) for kd in ("uniform", "constant", "mod3")
                  for pos in ((0, 1, 2, 3), (8,), (26, 27, 28, 29, 30, 31)) for ns in (0, 1)]
    k1k2_cases.append((MAIN_N, "uniform", (0, 1, 2, 3), 1))  # the main path's pass
    for n, kd, pos, ns in k1k2_cases:
        label = f"n={n} keys={kd} bits={pos} payloads={ns}"
        keys = words(n, kd)
        pays = [torch.arange(n, dtype=torch.int32, device=dev)][:ns]
        gk, gp, counts = cs.group_tiles(keys, pays, pos)
        rk, rp, rc = cs.group_tiles_ref(keys, pays, pos)
        check_same("group_tiles", label, [gk, *gp, counts], [rk, *rp, rc])
        del rk, rp, rc
        offsets = cs.run_offsets(counts)
        sk, sp = cs.scatter_runs(gk, gp, counts, offsets, pos)
        rk, rp = cs.scatter_runs_ref(gk, gp, counts, offsets, pos)
        check_same("scatter_runs", label, [sk, *sp], [rk, *rp])
        del keys, pays, gk, gp, counts, offsets, sk, sp, rk, rp
    k3_cases = 0
    for n in (1, 2, 1000, 10000, cs.SINGLE_TILE_MAX):
        for kd in ("uniform", "constant", "mod3"):
            for pos in (tuple(range(32)), tuple(range(12)), (31, 0, 17, 5, 9)):
                for ns in (0, 1):
                    keys = words(n, kd)
                    pays = [torch.arange(n, dtype=torch.int32, device=dev)][:ns]
                    got = cs.sort_single_tile(keys, pays, pos)
                    want = cs.sort_single_tile_ref(keys, pays, pos)
                    check_same("sort_single_tile", f"n={n} keys={kd} bits={pos} payloads={ns}",
                               [got[0], *got[1]], [want[0], *want[1]])
                    k3_cases += 1
    torch.cuda.synchronize()
    print(f"kernels vs plain versions: bit-identical, max_abs_err {max_err} "
          f"({len(k1k2_cases)} K1/K2 cases, {k3_cases} K3 cases, {time.perf_counter() - t0:.1f} s)")

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
        out_k, out_v = glu_tpu_torch.radix_sort(keys, values, steps)
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
    big = per_case["2^28 uniform"]
    if big != {"group_tiles": 8, "scatter_runs": 8, "sort_single_tile": 0}:
        raise AssertionError(f"2^28 sort launched {big}, want 8/8/0")
    if per_case["10000 uniform (single tile)"] != {"group_tiles": 0, "scatter_runs": 0, "sort_single_tile": 1}:
        raise AssertionError(f"single-tile sort launched {per_case['10000 uniform (single tile)']}")
    if per_case["2^24 uniform num_steps=3"]["group_tiles"] != 3:
        raise AssertionError("num_steps=3 did not run 3 passes")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    print(f"launch counts over the main path: {launches}")

    # -- 6. K4 and K5 against their plain versions -----------------------------
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
    for shape, dt, op in fold_cases:
        if dt.is_floating_point and op == Op.MUL and shape[1] > 100_003:
            shape = (shape[0], 100_003)  # a long float product drifts by its rounding
        label = f"{op.name} {dt} {shape}"
        x = fold_input(dt, op, shape)
        check_close("reduce", label, cr.reduce_partitions(x, op), cr.reduce_partitions_ref(x, op))
        check_close("exclusive_scan", label, csc.exclusive_scan_partitions(x, op),
                    csc.exclusive_scan_partitions_ref(x, op))
        del x
    torch.cuda.synchronize()
    print(f"K4/K5 vs plain versions: {len(fold_cases)} cases each, integers bit-identical, floats within "
          f"rtol {FLOAT_TOL['rtol']} atol {FLOAT_TOL['atol']}; max_abs_err exclusive_scan "
          f"{max_err['exclusive_scan']!r} reduce {max_err['reduce']!r} ({time.perf_counter() - t0:.1f} s)")

    # -- 7. the scan and reduce main path at full width -------------------------
    import numpy as np

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
    check_exact("exclusive_scan 2^28 u32 SUM", slice_call("exclusive_scan", lambda: glu_tpu_torch.exclusive_scan(u), (3, 0)),
                glu_tpu_torch.exclusive_scan(u, backend="torch"))
    check_exact("inclusive_scan 2^28 u32 SUM", slice_call("inclusive_scan", lambda: glu_tpu_torch.inclusive_scan(u), (3, 0)),
                glu_tpu_torch.inclusive_scan(u, backend="torch"))
    check_exact("reduce 2^28 u32 SUM", slice_call("reduce", lambda: glu_tpu_torch.reduce(u), (0, 2)),
                glu_tpu_torch.reduce(u, backend="torch"))
    del u
    f = torch.rand(MAIN_N, dtype=torch.float32, device=dev, generator=gen)
    check_exact("reduce 2^28 f32 MAX", slice_call("reduce f32", lambda: glu_tpu_torch.reduce(f, Op.MAX), (0, 2)),
                torch.amax(f))
    del f
    g = torch.rand(1 << 24, dtype=torch.float32, device=dev, generator=gen)
    exc = slice_call("exclusive_scan f32", lambda: glu_tpu_torch.exclusive_scan(g), (3, 0))
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
    seg = slice_call("segmented_reduce", lambda: glu_tpu_torch.segmented_reduce(v, offs), (3, 0))
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
    scanned = slice_call("BlellochScan", lambda: glu_tpu_torch.BlellochScan(DataType.UINT)(buf, 1 << 18, 4), (3, 0))
    want_host = np.concatenate([np.cumsum(p, dtype=np.uint32) - p for p in host.reshape(4, -1)])
    if not (buf.get_data() == want_host).all() or scanned.data_ptr() != buf.data.data_ptr():
        raise AssertionError("BlellochScan on a DeviceBuffer: not the numpy exclusive scan, in place")
    print("main path BlellochScan(UINT) 4 x 2^18 on a default-device DeviceBuffer: in place, identical to numpy")
    buf = glu_tpu_torch.DeviceBuffer(host)
    total = slice_call("Reduce", lambda: glu_tpu_torch.Reduce(DataType.UINT, Op.SUM)(buf, 1 << 20), (0, 2))
    if not int(total) == int(buf.get_data()[0]) == int(host.sum(dtype=np.uint32)):
        raise AssertionError("Reduce on a DeviceBuffer: not the numpy sum at buffer[0]")
    print("main path Reduce(UINT, SUM) 2^20 on a default-device DeviceBuffer: buffer[0] is the numpy sum")
    del buf
    fold_launches = {"exclusive_scan": csc.scan_launches, "reduce": cr.reduce_launches}
    if min(fold_launches.values()) < 1:
        raise AssertionError(f"a kernel of the scan/reduce path never launched: {fold_launches}")
    print(f"launch counts over the scan/reduce path: {fold_launches}")
    launches.update(fold_launches)

    # -- 8. timings, for the record ----------------------------------------------
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

    def turns(kernel_fn, plain_fn, reps: int = REPS):
        """(kernel ms, plain ms): the lower of two medians each, measured in
        turns plain, kernel, kernel, plain."""
        p_ms = [median_ms(plain_fn, reps)]
        k_ms = [median_ms(kernel_fn, reps), median_ms(kernel_fn, reps)]
        p_ms.append(median_ms(plain_fn, reps))
        return min(k_ms), min(p_ms)

    tag = f"[{gpu}]"
    keys = as_u32(words(MAIN_N, "uniform"))
    values = as_u32(torch.arange(MAIN_N, dtype=torch.int32, device=dev))
    sort_ms, torch_ms = turns(lambda: glu_tpu_torch.radix_sort(keys, values),
                              lambda: glu_tpu_torch.radix_sort(keys, values, backend="torch"))
    print(f"time radix_sort 2^28 pairs: port {sort_ms:.3f} ms = {MAIN_N / sort_ms / 1e3:.2f} M pairs/s; "
          f"torch.sort(stable)+gather {torch_ms:.3f} ms = {MAIN_N / torch_ms / 1e3:.2f} M pairs/s {tag}")
    kw, vw = keys.view(torch.int32), values.view(torch.int32)
    del keys, values
    pos = (0, 1, 2, 3)
    gk, gp, counts = cs.group_tiles(kw, [vw], pos)
    offsets = cs.run_offsets(counts)
    timing = {}
    timing["group_tiles"] = turns(lambda: cs.group_tiles(kw, [vw], pos),
                                  lambda: cs.group_tiles_ref(kw, [vw], pos))
    timing["scatter_runs"] = turns(lambda: cs.scatter_runs(gk, gp, counts, offsets, pos),
                                   lambda: cs.scatter_runs_ref(gk, gp, counts, offsets, pos))
    glue_ms = median_ms(lambda: cs.run_offsets(counts))
    del gk, gp, counts, offsets, kw, vw
    sk = words(cs.SINGLE_TILE_MAX, "uniform")
    sv = torch.arange(cs.SINGLE_TILE_MAX, dtype=torch.int32, device=dev)
    full = tuple(range(32))
    timing["sort_single_tile"] = turns(lambda: cs.sort_single_tile(sk, [sv], full),
                                       lambda: cs.sort_single_tile_ref(sk, [sv], full), reps=20)

    def sort_and_gather():
        r = torch.sort(sk, stable=True)
        return r.values, sv[r.indices]

    library = {"group_tiles": None, "scatter_runs": None, "sort_single_tile": median_ms(sort_and_gather, reps=20)}
    pair_bytes = MAIN_N * 2 * 4
    counts_bytes = (MAIN_N // cs.TILE) * 16 * 4
    bounds = {
        "group_tiles": _bound(2 * pair_bytes + counts_bytes, MAIN_N),
        "scatter_runs": _bound(2 * pair_bytes + 2 * counts_bytes, MAIN_N),
        "sort_single_tile": _bound(2 * cs.SINGLE_TILE_MAX * 2 * 4, 8 * cs.SINGLE_TILE_MAX),
    }
    del sk, sv
    for name, (k_ms, p_ms) in timing.items():
        shape = "2^28 pairs, one 4-bit pass" if name != "sort_single_tile" else f"{cs.SINGLE_TILE_MAX} pairs, 32 bits"
        lib_text = "" if library[name] is None else f", torch.sort(stable)+gather {library[name]:.4f} ms"
        print(f"time {name} ({shape}): kernel {k_ms:.4f} ms, plain torch {p_ms:.4f} ms{lib_text}, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) {tag}")
    print(f"time run_offsets glue (2^28 pairs, one pass): {glue_ms:.3f} ms {tag}")

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
        "exclusive_scan": turns(lambda: glu_tpu_torch.exclusive_scan(u), lambda: glu_tpu_torch.exclusive_scan(u, backend="torch"), reps=FOLD_REPS),
        "reduce": turns(lambda: glu_tpu_torch.reduce(u), lambda: glu_tpu_torch.reduce(u, backend="torch"), reps=FOLD_REPS),
    }
    for name, (k_ms, t_ms) in api.items():
        print(f"time glu_tpu_torch.{name} (2^28 u32 SUM): backend cuda {k_ms:.4f} ms, backend torch {t_ms:.4f} ms {tag}")
    for label, fn in (("exclusive_scan", lambda: csc.exclusive_scan_partitions(u2, Op.SUM)),
                      ("reduce", lambda: cr.reduce_partitions(u2, Op.SUM))):
        for line in _profile_kernels(torch, fn):
            print(f"profile {label} (2^28 u32 SUM): {line} {tag}")
    del u, u2, w32

    kernels = {  # name: (source, TPU kernel it replaces)
        "group_tiles": ("glu_tpu_torch/csrc/radix_sort.cu", "glu_tpu/ops/_pallas_sort.py:256"),
        "scatter_runs": ("glu_tpu_torch/csrc/radix_sort.cu", "glu_tpu/ops/_pallas_sort.py:542"),
        "sort_single_tile": ("glu_tpu_torch/csrc/radix_sort.cu", "glu_tpu/ops/_pallas_sort.py:653"),
        "exclusive_scan": ("glu_tpu_torch/csrc/scan.cu", "glu_tpu/ops/_pallas_scan.py:201"),
        "reduce": ("glu_tpu_torch/csrc/reduce.cu", "glu_tpu/ops/_pallas_reduce.py:110"),
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
