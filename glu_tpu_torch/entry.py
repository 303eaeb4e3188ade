"""Entry points of the port (counterpart of __graft_entry__.py).

`entry()` gives the main path as a function and its example inputs: the
stable key/value sort of 65,536 u32 pairs, on the card. `dryrun_multichip(n)`
runs the distributed layer once over an n-rank process group on tiny
shapes, one spawned process a rank: the distributed sort under both local
backends, with 2 chunks, with `bits="auto"` on low-entropy keys and on
64-bit keys, and the distributed reduce and exclusive scan, each rank's
result checked against numpy.

On the card a rank is a process on its own card (NCCL); with
`device="cpu"` the ranks are CPU processes (gloo). Neither falls back to
the other: with no card, or fewer cards than ranks, both raise GluError
before anything starts.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import tempfile
import time
import traceback

import numpy as np
import torch

from .ops.backend import resolve_backend
from .ops.radix_sort import radix_sort
from .utils.buffers import default_device, from_numpy, to_numpy
from .utils.errors import GluError, check_argument, check_state

ENTRY_N = 65536  # pairs of entry()'s example: SINGLE_TILE_MAX, so K3 alone, on a cluster of CTAs
DRYRUN_N_LOCAL = 1024  # pairs a rank in dryrun_multichip
COLLECTIVE_TIMEOUT_S = 60  # the process group's: a collective that waits longer raises
DRYRUN_TIMEOUT_S = 300  # the whole dry run: spawn, import torch, join the group, the cases


def entry(device=None):
    """(fn, (keys, values)): the stable u32 key/value radix sort and its
    example inputs, 65,536 pairs of torch.uint32 on `device` (by default
    the card; raises GluError without one). The keys come from a
    torch.Generator seeded with 0 on the CPU, so every device gets the same
    ones; the values are arange(65,536). `fn(keys, values)` is radix_sort
    with the backend resolved once, here ("cuda" unless
    GLU_TPU_TORCH_BACKEND says otherwise): on the card, one sort_single_tile
    launch (K3 on a thread-block cluster), as the JAX entry's sort is one
    _single_block_sort."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(-(2**31), 2**31, (ENTRY_N,), dtype=torch.int32, generator=gen)
    keys = keys.to(device).view(torch.uint32)
    values = torch.arange(ENTRY_N, dtype=torch.int32, device=device).view(torch.uint32)
    backend = resolve_backend(None, keys)

    def fn(keys, values):
        return radix_sort(keys, values, backend=backend)

    return fn, (keys, values)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the distributed layer once over an n_devices-rank process group,
    one spawned process a rank (the cases of __graft_entry__.py's
    dryrun_multichip; see the module's docstring). device None (or "cuda")
    puts rank r on card r under NCCL, and raises GluError when fewer than
    n_devices cards are present; "cpu" runs gloo processes. Waits at most
    DRYRUN_TIMEOUT_S; any rank's failure or death ends every rank and
    raises GluError with its traceback."""
    check_argument(isinstance(n_devices, int) and n_devices >= 1, "n_devices must be a positive int, got %r",
                   n_devices)
    kind = default_device(device).type
    check_argument(kind in ("cpu", "cuda"), "dryrun_multichip runs on cpu or cuda, not %s", kind)
    if kind == "cuda":
        have = torch.cuda.device_count()
        check_state(have >= n_devices, "need %d CUDA devices, have %d", n_devices, have)
    ctx = mp.get_context("spawn")
    answers = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="glu_dryrun_") as tmp:
        procs = [ctx.Process(target=_dryrun_rank, args=(r, n_devices, f"{tmp}/store", kind, answers), daemon=True)
                 for r in range(n_devices)]
        try:
            for p in procs:
                p.start()
            _await_ranks(procs, answers, time.monotonic() + DRYRUN_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join(10)
            answers.cancel_join_thread()
            answers.close()


def _await_ranks(procs, answers, deadline: float) -> None:
    """Wait for every rank's answer, (rank, None) or (rank, traceback), on
    `answers`; raise GluError at the first failure, at the first rank that
    ends without answering, or at the deadline."""
    done = set()
    while len(done) < len(procs):
        try:
            rank, failure = answers.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in done and not p.is_alive()]
            if dead:
                try:  # an answer sent just before the process ended
                    rank, failure = answers.get(timeout=1)
                except queue.Empty:
                    raise GluError(f"dryrun_multichip: rank {dead[0]} of {len(procs)} ended with exit code "
                                   f"{procs[dead[0]].exitcode} and no answer") from None
            elif time.monotonic() > deadline:
                raise GluError(f"dryrun_multichip: ranks {sorted(set(range(len(procs))) - done)} of {len(procs)} "
                               "did not answer in time")
            else:
                continue
        if failure is not None:
            raise GluError(f"dryrun_multichip: rank {rank} of {len(procs)} failed:\n{failure}")
        done.add(rank)


def _dryrun_rank(rank: int, world: int, store_path: str, kind: str, answers) -> None:
    """A rank's process: join the group, run the cases, answer."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        device = torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")
        if kind == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            _dryrun_cases(rank, world, device)
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent raises it; a hung collective raises after the group's timeout
        answers.put((rank, traceback.format_exc()))
        return
    answers.put((rank, None))


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _dryrun_cases(rank: int, world: int, device: torch.device) -> None:
    """Every case on this rank's slice of one global array, the same on
    every rank (made from a seed), each checked against numpy."""
    from .ops.reduce import ReduceOperator
    from .parallel import (distributed_exclusive_scan, distributed_radix_sort, distributed_radix_sort_u64_parts,
                           distributed_reduce)

    n = DRYRUN_N_LOCAL * world
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    values = np.arange(n, dtype=np.uint32)
    mine = slice(rank * DRYRUN_N_LOCAL, (rank + 1) * DRYRUN_N_LOCAL)

    def shard(a: np.ndarray) -> torch.Tensor:
        return from_numpy(a[mine], device)

    def check_sort(label: str, out, order: np.ndarray, streams) -> None:
        """out: (*sorted streams, counts, overflow) of this rank; order:
        the global stable order; streams: the global arrays it permutes."""
        *got, counts, overflow = (to_numpy(t) for t in out)
        _expect(int(counts.sum()) == n and not overflow.any(),
                f"{label}: counts {counts.tolist()} (want a total of {n}), overflow {overflow.tolist()}")
        start = int(counts[:rank].sum())
        mine_sorted = order[start:start + int(counts[rank])]
        for i, (g, a) in enumerate(zip(got, streams)):
            _expect(np.array_equal(g, a[mine_sorted]), f"{label}: output {i} differs from numpy's stable sort")

    order = np.argsort(keys, kind="stable")
    for backend in ("torch", "cuda"):
        check_sort(f"distributed_radix_sort backend={backend}",
                   distributed_radix_sort(shard(keys), shard(values), backend=backend), order, (keys, values))
    check_sort("distributed_radix_sort pipeline_chunks=2",
               distributed_radix_sort(shard(keys), shard(values), backend="torch", pipeline_chunks=2),
               order, (keys, values))
    low = keys % np.uint32(1000)
    check_sort('distributed_radix_sort bits="auto"',
               distributed_radix_sort(shard(low), shard(values), backend="torch", bits="auto"),
               np.argsort(low, kind="stable"), (low, values))
    wide = (hi.astype(np.uint64) << np.uint64(32)) | keys
    check_sort("distributed_radix_sort_u64_parts",
               distributed_radix_sort_u64_parts(shard(hi), shard(keys), shard(values), backend="torch"),
               np.argsort(wide, kind="stable"), (hi, keys, values))

    total = to_numpy(distributed_reduce(shard(keys), None, ReduceOperator.SUM, backend="cuda"))
    _expect(int(total) == int(keys.sum(dtype=np.uint32)), f"distributed_reduce: {int(total)}")
    exclusive = to_numpy(distributed_exclusive_scan(shard(keys), backend="cuda"))
    _expect(np.array_equal(exclusive, (np.cumsum(keys, dtype=np.uint32) - keys)[mine]),
            "distributed_exclusive_scan differs from numpy")
