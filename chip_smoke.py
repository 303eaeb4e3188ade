#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (glu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which raises (exit code 1) on any failure:
  1. device: a CUDA device is required; prints nvidia-smi's name and power
     limit and the torch/CUDA versions;
  2. build: compiles glu_tpu_torch/csrc/*.cu with nvcc for sm_90a;
  3. each kernel (group_tiles, scatter_runs, sort_single_tile) against its
     plain torch version on the card, bit for bit, at the main path's shape
     and at small ragged shapes;
  4. the main path: glu_tpu_torch.radix_sort on 2**28 u32 key/value pairs
     and on smaller and edge-case inputs, bit for bit against
     radix_sort(..., backend="torch") (one stable torch.sort) on the card;
  5. launch counts: the 2**28 sort ran group_tiles and scatter_runs 8 times
     each and sort_single_tile never; the small sort ran sort_single_tile;
  6. timings (CUDA events, medians), for the record only.
The last line is {"ok": true, "device": {...}}; the line before it is the
JSON summary of the kernels, and the one before that nvidia-smi's line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 20260
MAIN_N = 1 << 28
REPS = 3


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


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
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

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

    # -- 6. timings, for the record ----------------------------------------------
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
    for name, (k_ms, p_ms) in timing.items():
        shape = "2^28 pairs, one 4-bit pass" if name != "sort_single_tile" else f"{cs.SINGLE_TILE_MAX} pairs, 32 bits"
        print(f"time {name} ({shape}): kernel {k_ms:.3f} ms, plain torch {p_ms:.3f} ms {tag}")
    print(f"time run_offsets glue (2^28 pairs, one pass): {glue_ms:.3f} ms {tag}")

    source = "glu_tpu_torch/csrc/radix_sort.cu"
    replaces = {
        "group_tiles": "glu_tpu/ops/_pallas_sort.py:256",
        "scatter_runs": "glu_tpu/ops/_pallas_sort.py:542",
        "sort_single_tile": "glu_tpu/ops/_pallas_sort.py:653",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name in ("group_tiles", "scatter_runs", "sort_single_tile")
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
