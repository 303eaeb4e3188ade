"""Pools of gloo processes for the CPU tests of glu_tpu_torch.parallel.

A pool is D processes started with the "spawn" method, one per rank of a
gloo process group that meets through a FileStore (no TCP port to collide
with other test workers). Each process imports torch and the port, never
jax, runs with one thread, and serves tasks from its own queue until it is
told to stop. The parent sends every rank the same task (with the rank's
own arguments) and waits for all D answers with a timeout; a collective
that hangs raises in its process after the group's timeout, so no wait is
longer than that.

    pool = RankPool(4, store_dir)
    answers = pool.run("parallel_call", [args_of_rank_r for r in range(4)], kwargs)
    pool.close()

Each answer is ("ok", result) or ("error", (type name, message, whether it
is a GluError, traceback)). A task's arguments and results are numpy arrays
and plain values; the process converts them to and from CPU tensors.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback

COLLECTIVE_TIMEOUT_S = 60  # the process group's: a collective that waits longer raises
START_TIMEOUT_S = 120  # spawn, import torch, join the group
RUN_TIMEOUT_S = COLLECTIVE_TIMEOUT_S + 30

_TASKS = {}


def _task(fn):
    _TASKS[fn.__name__] = fn
    return fn


def _to_torch(a):
    import numpy as np

    from glu_tpu_torch import from_numpy

    return from_numpy(a, "cpu") if isinstance(a, np.ndarray) else a


def _to_numpy(x):
    import torch

    from glu_tpu_torch import to_numpy

    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    if isinstance(x, (tuple, list)):
        return tuple(_to_numpy(v) for v in x)
    return x


@_task
def parallel_call(fn_name: str, args, kwargs):
    """glu_tpu_torch.parallel.<fn_name>(*args, **kwargs) on this rank's
    shards; a kwarg "op" names a ReduceOperator."""
    import glu_tpu_torch.parallel as par
    from glu_tpu_torch import ReduceOperator

    kwargs = dict(kwargs)
    if "op" in kwargs:
        kwargs["op"] = ReduceOperator[kwargs["op"]]
    return _to_numpy(getattr(par, fn_name)(*(_to_torch(a) for a in args), **kwargs))


@_task
def traced_call(fn_name: str, args, kwargs):
    """parallel_call with the port's tracing on, from an empty store:
    (result, summary(), [(name, parent, call id) of each span record])."""
    from glu_tpu_torch.utils import timing

    timing.reset()
    timing.enable()
    try:
        result = parallel_call(fn_name, args, kwargs)
    finally:
        timing.disable()
    return result, timing.summary(), [(r.name, r.parent, r.call) for r in timing.records()]


@_task
def primitives(x, op_name: str, backends):
    """The three distributed primitives of this rank's shard x under each
    backend: {backend: (reduce, exclusive, inclusive)}."""
    import glu_tpu_torch.parallel as par
    from glu_tpu_torch import ReduceOperator

    op, t = ReduceOperator[op_name], _to_torch(x)
    return {
        b: _to_numpy((par.distributed_reduce(t, None, op, backend=b),
                      par.distributed_exclusive_scan(t, None, op, backend=b),
                      par.distributed_inclusive_scan(t, None, op, backend=b)))
        for b in backends
    }


@_task
def sort_on_subgroup(ranks, keys, values, kwargs):
    """distributed_radix_sort over make_sort_mesh(ranks), which every rank
    creates; ranks outside it return None."""
    import torch.distributed as dist

    import glu_tpu_torch.parallel as par

    group = par.make_sort_mesh(ranks)
    if dist.get_rank() not in ranks:
        return None
    return _to_numpy(par.distributed_radix_sort(_to_torch(keys), _to_torch(values), group, **kwargs))


def _serve(rank: int, world_size: int, store_path: str, inbox, outbox) -> None:
    """A rank's process: join the group, then answer tasks until None."""
    import torch
    import torch.distributed as dist

    from glu_tpu_torch import GluError

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    except Exception as e:  # reported to the parent, which fails the test
        outbox.put((rank, "error", (type(e).__name__, str(e), False, traceback.format_exc())))
        return
    outbox.put((rank, "ready", None))
    try:
        while (msg := inbox.get()) is not None:
            name, args, kwargs = msg
            try:
                result = _TASKS[name](*args, **kwargs)
                pickle.dumps(result)  # a result the queue cannot send fails here, not in its feeder thread
                outbox.put((rank, "ok", result))
            except Exception as e:  # the test reads it; the process serves on
                outbox.put((rank, "error", (type(e).__name__, str(e), isinstance(e, GluError),
                                            traceback.format_exc())))
    finally:
        dist.destroy_process_group()


class PoolError(RuntimeError):
    """A pool's processes did not all answer in time, or failed to start."""


class RankPool:
    """D gloo processes serving tasks (see the module's docstring). A pool
    whose ranks did not all answer, or answered with errors other than one
    GluError on every rank (which may leave ranks of a collective behind),
    is closed, and the next task starts a new one."""

    def __init__(self, world_size: int, store_dir: str):
        self.world_size = world_size
        self.store_dir = store_dir
        self.generation = 0
        self.procs = []
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self.generation += 1
        path = os.path.join(self.store_dir, f"store_d{self.world_size}_{self.generation}")
        self.inbox = [ctx.Queue() for _ in range(self.world_size)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, self.world_size, path, self.inbox[r], self.outbox),
                                  daemon=True) for r in range(self.world_size)]
        for p in self.procs:
            p.start()
        self.ready = False

    def _collect(self, timeout: float) -> list:
        deadline = time.monotonic() + timeout
        got = {}
        while len(got) < self.world_size:
            try:
                rank, status, payload = self.outbox.get(timeout=1)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    raise PoolError(f"{self.world_size} ranks: only {sorted(got)} answered, ranks {dead} ended, "
                                    f"within {timeout} s") from None
                continue
            got[rank] = (status, payload)
        return [got[r] for r in range(self.world_size)]

    def run(self, name: str, per_rank_args, kwargs=None, timeout: float = RUN_TIMEOUT_S) -> list:
        """Task `name` on every rank (rank r with per_rank_args[r]); the D
        answers in rank order."""
        if not self.procs:
            self._start()
        if not self.ready:
            started = self._collect(START_TIMEOUT_S)
            if any(status != "ready" for status, _ in started):
                self.close()
                raise PoolError(f"a rank failed to start: {started}")
            self.ready = True
        for r in range(self.world_size):
            self.inbox[r].put((name, per_rank_args[r], kwargs or {}))
        answers = self._collect(timeout)
        if any(s == "error" for s, _ in answers) and not all(s == "error" and p[2] for s, p in answers):
            self.close()
        return answers

    def stop(self) -> None:
        """Ask every rank to leave (close() then waits for them)."""
        for q in self.inbox if self.procs else ():
            q.put(None)

    def close(self) -> None:
        if not self.procs:
            return
        self.stop()
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        for q in (*self.inbox, self.outbox):
            q.cancel_join_thread()
            q.close()
        self.procs = []


def results(answers: list) -> list:
    """The results of a task that every rank must have finished; raises
    with the first rank's traceback otherwise."""
    for rank, (status, payload) in enumerate(answers):
        if status != "ok":
            raise AssertionError(f"rank {rank} of {len(answers)} failed:\n{payload[3]}")
    return [payload for _, payload in answers]
