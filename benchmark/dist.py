"""A cell on several cards: one process a card, spawned by the run's own
process, over NCCL (gloo processes on the CPU, to rehearse).

The parent builds the kernel library once (so that the ranks load it and
do not race to build it), then spawns the ranks; they meet through a
FileStore in a directory under the run's TMPDIR. Every rank makes its own
shard from the seed, warms up, times set-up's last steps, and all ranks
take the slowest time to agree on how many steps fill `--seconds`; then
each runs the window between a barrier and a synchronize and checks its
kept answers against its slice of the reference's global order. The
parent reads every rank's report from its pipe within a deadline, ends every rank
that is left on any failure, waits until every rank and multiprocessing's
resource tracker have ended, and combines the reports: the slowest
rank's window, its set-up, every rank's traces and the sums of their
checks.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time
import traceback

import torch

COLLECTIVE_TIMEOUT_S = 120  # the group's: a collective that waits longer raises
DEADLINE_S = 290  # from the run's start: every rank has reported, or the run fails
EXIT_S = 25  # for the ranks to end of themselves after their reports, and again after a kill
TIMED_STEPS = 3  # set-up's steps that time a step


def _rank(rank: int, world: int, store: str, job: dict, report) -> None:
    """A rank's process: join the group, run, send (status, payload) on
    `report`, this rank's end of its pipe to the parent."""
    import torch.distributed as dist

    try:
        from . import harness

        setup = harness.Setup(job["t_start"])
        setup.mark("spawned")
        harness.apply_patch(job["patch"])  # not undone: the process ends with the run
        on_card = job["device_type"] == "cuda"
        device = torch.device("cuda", rank) if on_card else torch.device("cpu")
        if on_card:
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        else:
            torch.set_num_threads(1)
        dist.init_process_group("nccl" if on_card else "gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                                **({"device_id": device} if on_card else {}))
        setup.mark("group")
        try:
            report.send(("ok", _run(rank, world, device, job, setup)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        report.send(("error", traceback.format_exc()))
        raise


def _run(rank: int, world: int, device: torch.device, job: dict, setup) -> dict:
    import torch.distributed as dist

    from . import harness
    from .workload import Workload

    sync = harness.syncer(device)
    work = Workload(job["config"], job["traffic"], job["seed"], device, rank, world)
    sync()
    setup.mark("inputs")
    harness.warm_up(work, sync)
    setup.mark("warm_up")
    dist.barrier()
    sync()
    t = time.perf_counter()
    for i in range(TIMED_STEPS):
        work.call(i)
    sync()
    step_s = torch.tensor([(time.perf_counter() - t) / TIMED_STEPS], dtype=torch.float64, device=device)
    dist.all_reduce(step_s, op=dist.ReduceOp.MAX)
    steps = max(1, round(job["seconds"] / float(step_s)))
    dist.barrier()
    setup.mark("timed_steps")
    measured = harness.window(work, job["seconds"], job["trace"], sync, steps=steps)
    run = harness.Run(job["config"], job["traffic"], steps=measured["steps"], window_s=measured["window_s"],
                      setup_s=measured["wall_start"] - job["t_start"], setup_marks=setup.marks,
                      traces=None if measured["trace"] is None else [measured["trace"]],
                      work_per_step=max(work.work_per_step))
    run.work = run.steps * run.work_per_step
    harness.finish(work, measured, run)
    return run.__dict__


def run_ranks(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, world: int, device_type: str,
              t_start: float, patch: str | None):
    """The run over `world` ranks; a harness.Run of them all."""
    import torch.multiprocessing as mp

    from . import harness

    setup = harness.Setup(t_start)
    setup.mark("imports")
    if device_type == "cuda":
        setup.build()  # once, here, so that the ranks load the library and do not race to build it
    job = {"config": config, "traffic": traffic, "seed": seed, "seconds": seconds, "trace": trace,
           "device_type": device_type, "t_start": t_start, "patch": patch}
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]  # (parent's end, rank's end), one a rank
    with tempfile.TemporaryDirectory(prefix="bench_store_") as tmp:
        procs = [ctx.Process(target=_rank, args=(r, world, os.path.join(tmp, "store"), job, pipes[r][1]))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            for _, theirs in pipes:
                theirs.close()  # so that a rank that ends without a report reads as the end of its pipe
            reports = _collect([ours for ours, _ in pipes], t_start + DEADLINE_S)
            reported = time.time()
        finally:
            _end(procs)
            for ours, theirs in pipes:
                ours.close()
                theirs.close()
        print(f"dist: every rank ended {time.time() - reported:.3f} s after the last report", file=sys.stderr)
    _stop_resource_tracker()
    runs = [reports[r] for r in range(world)]
    run = harness.Run(config, traffic, steps=runs[0]["steps"], window_s=max(r["window_s"] for r in runs),
                      setup_s=max(r["setup_s"] for r in runs), work=runs[0]["work"], compile_s=setup.compile_s,
                      setup_marks={**setup.marks, **max(runs, key=lambda r: r["setup_s"])["setup_marks"]},
                      work_per_step=runs[0]["work_per_step"],
                      traces=[r["traces"][0] for r in runs] if runs[0]["traces"] else None,
                      memory_peak_bytes=max(r["memory_peak_bytes"] for r in runs),
                      forbidden=sorted({m for r in runs for m in r["forbidden"]} | set(harness.forbidden_modules())))
    if len({r["steps"] for r in runs}) != 1:
        raise RuntimeError(f"ranks ran different numbers of steps: {[r['steps'] for r in runs]}")
    run.checks = {k: sum(r["checks"][k] for r in runs) for k in runs[0]["checks"]}
    run.answers = sum(r["answers"] for r in runs)
    run.wrong = sum(r["wrong"] for r in runs)
    return run


def _end(procs: list) -> None:
    """Waits until every started rank has ended: EXIT_S in all for them to
    end of themselves, then a kill and EXIT_S more. Raises, naming them,
    if any is still there."""
    started = [p for p in procs if p.pid is not None]
    until = time.time() + EXIT_S
    for p in started:
        p.join(max(0.0, until - time.time()))
    for p in (p for p in started if p.is_alive()):
        p.kill()
    until = time.time() + EXIT_S
    for p in started:
        p.join(max(0.0, until - time.time()))
    left = [p.pid for p in started if p.is_alive()]
    if left:
        raise RuntimeError(f"rank processes {left} did not end after a kill")


def _stop_resource_tracker() -> None:
    """Ends multiprocessing's resource tracker, which starting the ranks
    started, and waits for it, so that no process outlives the run (it
    would end only once this process's end closed its pipe). It tracks
    nothing here: the reports come over pipes, which need no semaphore. A
    later start of processes starts it again."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if hasattr(tracker, "_stop"):
        tracker._stop()
    elif tracker._fd is not None:
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


def _collect(pipes: list, deadline: float) -> dict:
    """Every rank's report, read from its pipe; raises as soon as a rank
    fails or ends without one, or at the deadline (wall clock)."""
    from multiprocessing import connection

    reports, waiting = {}, dict(enumerate(pipes))
    while waiting:
        ready = connection.wait(list(waiting.values()), timeout=1)
        if not ready and time.time() > deadline:
            raise RuntimeError(f"ranks {sorted(reports)} of {len(pipes)} reported before the deadline")
        for rank in [r for r, pipe in waiting.items() if pipe in ready]:
            try:
                status, payload = waiting.pop(rank).recv()
            except EOFError:
                raise RuntimeError(f"rank {rank} ended without a report") from None
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            reports[rank] = payload
    return reports
