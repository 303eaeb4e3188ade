#!/usr/bin/env python3
"""The distributed layer (glu_tpu_torch.parallel) across the ranks of one
host: one process a card over NCCL, or gloo processes on the CPU to
rehearse without cards.

    python3 tools/dist_check.py                    # every visible card, 2**28 pairs
    python3 tools/dist_check.py --device cpu --world 4 --n 65536

Every rank makes the same global arrays from one seed, keeps its shard and
runs the distributed function on it; its output must equal its slice of
the single-card function on the whole array, bit for bit (the sort's slice
of rank r starts at the sum of counts[:r]): distributed_radix_sort of u32
pairs with pipeline_chunks 1 and 2 and descending with bits="auto",
distributed_radix_sort_f32 and _u64 at n / 16, and distributed_reduce and
the scans of n u32 (SUM). Then timings, CUDA events (the host clock on
the CPU) between barriers, the median over the calls of the slowest rank:
the distributed sort of n pairs with 1 and 2 chunks against radix_sort of
the whole array on one rank's device, and the sort's stages (_bucket_of,
KB on the card, whose buckets must equal its plain version's bit for bit
on every rank; the partition, the exchange of the two streams and the
local sort), each beside its bytes over 3.35 TB/s. The last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12
REPS = 5


def _worker(rank: int, world: int, store: str, args, results) -> None:
    import torch
    import torch.distributed as dist

    import glu_tpu_torch as glu
    from glu_tpu_torch import parallel
    from glu_tpu_torch.parallel import _cuda_bucket as cb
    from glu_tpu_torch.parallel import dist_sort as ds

    on_card = args.device == "cuda"
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        results.put((rank, _run(torch, dist, glu, parallel, cb, ds, rank, world, dev, args)))
    finally:
        dist.destroy_process_group()


def _run(torch, dist, glu, parallel, cb, ds, rank: int, world: int, dev, args) -> dict:
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n, n_local = args.n, args.n // world
    mine = slice(rank * n_local, (rank + 1) * n_local)
    u32 = lambda t: t.view(torch.uint32)  # noqa: E731

    def words(count: int, mask: int = -1) -> torch.Tensor:
        return torch.randint(-(2**31), 2**31, (count,), dtype=torch.int32, device=dev, generator=gen) & mask

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def same(label: str, got, want) -> None:
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"rank {rank} {label}: output {i} differs from its reference")

    def my_slice(counts: torch.Tensor) -> slice:
        start = int(counts[:rank].sum())
        return slice(start, start + int(counts[rank]))

    # -- correctness: every rank's output against its slice of the single-card call
    keys, values = u32(words(n)), u32(torch.arange(n, dtype=torch.int32, device=dev))
    checked = []
    sorts = [("u32, 1 chunk", parallel.distributed_radix_sort, glu.radix_sort, (keys, values), {"pipeline_chunks": 1}),
             ("u32, 2 chunks", parallel.distributed_radix_sort, glu.radix_sort, (keys, values), {"pipeline_chunks": 2}),
             ("u32 & 0xFFFFF, descending, bits auto", parallel.distributed_radix_sort, glu.radix_sort,
              (u32(words(n, 0xFFFFF)), values), {"descending": True, "bits": "auto"})]
    m = n // 16
    f32 = torch.randn(m, device=dev, generator=gen)
    u64 = words(2 * m).view(torch.uint64)
    sorts += [("f32", parallel.distributed_radix_sort_f32, glu.radix_sort_f32, (f32, values[:m]), {}),
              ("u64", parallel.distributed_radix_sort_u64, glu.radix_sort_u64, (u64, values[:m]), {})]
    for label, dist_fn, single_fn, full, kw in sorts:
        part = full[0].shape[0] // world
        shard = [a[rank * part:(rank + 1) * part] for a in full]
        got = dist_fn(*shard, backend="cuda", **kw)
        counts, overflow = got[-2], got[-1]
        if int(counts.sum()) != full[0].shape[0] or overflow.any():
            raise AssertionError(f"rank {rank} {label}: counts {counts.tolist()}, overflow {overflow.tolist()}")
        want = single_fn(*full, backend="cuda", **{k: v for k, v in kw.items() if k != "pipeline_chunks"})
        same(label, got[:-2], [w[my_slice(counts)] for w in want])
        checked.append(f"sort {label} against its slice of the single-card call: counts {counts.tolist()}")
    x = u32(words(n))
    for label, dist_fn, single_fn in (("reduce", parallel.distributed_reduce, glu.reduce),
                                      ("exclusive_scan", parallel.distributed_exclusive_scan, glu.exclusive_scan),
                                      ("inclusive_scan", parallel.distributed_inclusive_scan, glu.inclusive_scan)):
        got = dist_fn(x[mine], backend="cuda")
        want = single_fn(x, backend="cuda")
        same(label, [got], [want if label == "reduce" else want[mine]])
        checked.append(f"{label} of {n} u32 against its slice of the single-card call")
    del f32, u64, x

    # -- timings --------------------------------------------------------------------
    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(REPS):
            dist.barrier()
            sync()
            if on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                t = time.perf_counter()
                fn()
                ms = (time.perf_counter() - t) * 1e3
            slowest = torch.tensor([ms], dtype=torch.float64, device=dev)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
            times.append(float(slowest))
        return sorted(times)[len(times) // 2]

    k_mine, v_mine = keys[mine], values[mine]
    timings = {
        "distributed_radix_sort, 1 chunk": median_ms(
            lambda: parallel.distributed_radix_sort(k_mine, v_mine, backend="cuda", pipeline_chunks=1)),
        "distributed_radix_sort, 2 chunks": median_ms(
            lambda: parallel.distributed_radix_sort(k_mine, v_mine, backend="cuda", pipeline_chunks=2)),
        "radix_sort of the whole array on one device": median_ms(lambda: glu.radix_sort(keys, values, backend="cuda")),
    }
    samples, idx = ds._local_samples(k_mine, rank, 8192)
    splitters = ds._sample_splitters(parallel.dist_primitives._all_gather(samples, None).reshape(-1),
                                     parallel.dist_primitives._all_gather(idx, None).reshape(-1), world)
    bucket = ds._bucket_of(k_mine, rank, *splitters, "cuda")
    same("bucket_of (KB) against bucket_of_ref", [bucket], [cb.bucket_of_ref(k_mine, rank * n_local, *splitters)])
    checked.append(f"bucket_of (KB) of {n_local} keys a rank against bucket_of_ref")
    (pk, pv), counts, _ = ds._partition_by_bucket(bucket, [k_mine, v_mine], world, "cuda")
    rows = parallel.dist_primitives._all_gather(counts, None).cpu()
    send, recv = rows[rank].tolist(), rows[:, rank].tolist()
    out_k, out_v = (torch.empty(sum(recv), dtype=torch.int32, device=dev) for _ in range(2))

    def exchange() -> None:
        dist.all_to_all_single(out_k, pk.view(torch.int32), recv, send)
        dist.all_to_all_single(out_v, pv.view(torch.int32), recv, send)

    stages = {
        "_bucket_of": (median_ms(lambda: ds._bucket_of(k_mine, rank, *splitters, "cuda")), 8 * n_local),
        "_partition_by_bucket": (median_ms(lambda: ds._partition_by_bucket(bucket, [k_mine, v_mine], world, "cuda")),
                                 24 * n_local),
        "exchange (2 streams, all_to_all_single)": (median_ms(exchange), 8 * (n_local + sum(recv))),
        "local radix_sort": (median_ms(lambda: glu.radix_sort(u32(out_k), u32(out_v), backend="cuda")),
                             16 * sum(recv)),
    }
    return {"checked": checked, "timings_ms": timings,
            "stages_ms": {k: ms for k, (ms, _) in stages.items()},
            "stage_bounds_ms": {k: b / HBM_BYTES_PER_S * 1e3 for k, (_, b) in stages.items()},
            "received": sum(recv)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--world", type=int, default=0, help="ranks (default: every visible card)")
    parser.add_argument("--n", type=int, default=1 << 28, help="global pairs")
    parser.add_argument("--seed", type=int, default=20260)
    args = parser.parse_args()

    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("dist_check: no CUDA device available", file=sys.stderr)
            return 1
        args.world = args.world or torch.cuda.device_count()
        if args.world > torch.cuda.device_count():
            print(f"dist_check: {args.world} ranks, {torch.cuda.device_count()} cards", file=sys.stderr)
            return 1
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        device = f"{torch.cuda.get_device_name(0)} x {args.world}; nvidia-smi: {' | '.join(gpu)}"
    else:
        args.world = args.world or 4
        device = f"cpu x {args.world} gloo processes (a rehearsal: no device metric)"
    if args.n % (16 * args.world):
        print(f"dist_check: --n must be a multiple of 16 x {args.world}", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory(prefix="glu_dist_check_") as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_worker, args=(args.world, os.path.join(tmp, "store"), args, results),
                           nprocs=args.world, join=True, start_method="spawn")
        seconds = time.perf_counter() - t0
    by_rank = dict(results.get() for _ in range(args.world))
    print(f"device: {device}")
    for line in by_rank[0]["checked"]:
        print(f"bit-identical on every rank: {line}")
    for label, ms in by_rank[0]["timings_ms"].items():
        print(f"time {label} ({args.n} pairs, {args.world} ranks; the slowest rank, median of {REPS}): {ms:.4f} ms "
              f"[{device}]")
    for label, ms in by_rank[0]["stages_ms"].items():
        bound = by_rank[0]["stage_bounds_ms"][label]
        print(f"time rank 0 stage {label} ({args.n // args.world} pairs a rank, the slowest rank): {ms:.4f} ms, "
              f"bound {bound:.4f} ms (bytes over 3.35 TB/s) [{device}]")
    print(f"received per rank: {[by_rank[r]['received'] for r in range(args.world)]}; {seconds:.1f} s in all")
    print(json.dumps({"ok": True, "device": device, "world": args.world, "n": args.n,
                      "timings_ms": by_rank[0]["timings_ms"], "stages_ms": by_rank[0]["stages_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
