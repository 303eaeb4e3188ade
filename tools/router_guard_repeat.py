#!/usr/bin/env python3
"""Run chip_smoke.py's router guard (phase 10) several times in one process
on one NVIDIA GPU, and say how close each run came to failing it.

    python3 tools/router_guard_repeat.py [--runs N]

Each run makes a quick calibration and times, at every point of the guard,
backend="cuda", backend="torch" and backend=None under the shipped table and
under that calibration, as phase 10 does (its lines are printed as they
come). After each run the tool prints, for each model and point, the ratio
of the two backends' measured times and, where torch's route was over the
guard's limit, how far torch would have had to be ahead in the model for it
to route torch (the model's engine estimate over its torch estimate, less
1): the margin the router's tie rule (ops/router.py::TORCH_MARGIN) must
exceed. Ends with one JSON line: the runs that failed, the largest such
margin, and the range of the measured cuda/torch ratio of the sorts. Exit
code 1 when a run failed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

POINT = re.compile(r"router guard (.+?) n=(\d+) model=(\w+): route \w+, routed [\d.]+ ms, "
                   r"backend cuda ([\d.]+) ms, backend torch ([\d.]+) ms")
FRESH = re.compile(r"router: fresh calibration \(--quick, [\d.]+ s\): (\{.*\})")


def _estimates(router, model: dict, form: str, n: int):
    """(engine, torch) seconds of a guard point under a model, or None for
    the reduce, which has no estimate."""
    from glu_tpu_torch.ops import _cuda_sort as cs

    m = router._CostModel({**router._H100_MODEL, **model})
    full = cs.MAX_PASSES
    if form == "key/value":
        return router._cuda_sort_est_s(m, n, 1, full), router._torch_sort_est_s(m, n, 1)
    if form == "keys-only":
        return router._cuda_sort_est_s(m, n, 0, full), router._torch_sort_est_s(m, n, 0)
    if form.startswith("multi"):
        return router._cuda_sort_est_s(m, n, 2, full), router._torch_sort_est_s(m, n, 2)
    if form.startswith("bits"):
        return router._cuda_sort_est_s(m, n, 1, 1), router._torch_sort_est_s(m, n, 1, False)
    if form == "u64":
        return router._chain_est_s(m, n, (2, full), (2, full)), router._table_s(m.torch["u64"], n)
    if form.startswith("segmented"):
        return router._chain_est_s(m, n, (2, full), (2, 2)), router._table_s(m.torch["segmented"], n)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("router_guard_repeat: no CUDA device available", file=sys.stderr)
        return 1
    os.environ["GLU_TPU_TORCH_ROUTER_CALIBRATION"] = os.path.join(tempfile.gettempdir(),
                                                                  f"glu_tpu_torch_none_{os.getpid()}.json")
    os.environ.pop("GLU_TPU_TORCH_BACKEND", None)
    import chip_smoke
    from glu_tpu_torch.ops import router

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    failed, margins, ratios = [], [], []
    for run in range(args.runs):
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                chip_smoke._router_guard(torch, dev, gen, f"[run {run}]")
        except AssertionError as e:
            failed.append(run)
            print(f"run {run} FAILED: {e}")
        text = out.getvalue()
        print(text, end="")
        fresh = json.loads(FRESH.search(text).group(1))
        for form, n, model, c_ms, t_ms in POINT.findall(text):
            n, c_ms, t_ms = int(n), float(c_ms), float(t_ms)
            est = _estimates(router, fresh if model == "fresh" else router._H100_MODEL, form, n)
            if est is None:
                continue
            if model == "shipped":
                ratios.append(c_ms / t_ms)
            if not router.within_guard(t_ms, c_ms, t_ms):
                need = est[0] / est[1] - 1
                margins.append(need)
                print(f"run {run} {model} {form} n={n}: measured cuda/torch {c_ms / t_ms:.3f}; torch over the "
                      f"limit; the model's engine/torch estimate {est[0] / est[1]:.3f} (margin needed {need:+.3f})")
    print(json.dumps({"runs": args.runs, "failed": failed, "largest_margin_needed": max(margins, default=None),
                      "sort_cuda_over_torch": [min(ratios, default=None), max(ratios, default=None)],
                      "torch_margin": router.TORCH_MARGIN}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
