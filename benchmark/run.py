"""Runs one cell of BENCHMARK.json once on this machine's cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, `setup` (set-up's phases, and the seconds the kernels' build
compiled, which a checkout's first run pays), and last `checks`, each
number compared with its limit; the same numbers are the last lines of
standard error. Exits with 1 and prints
no result when torch finds fewer CUDA cards than the cell asks for, when
the run fails, or when jax, jaxlib, flax or glu_tpu was loaded.
"""

import time

T_START = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout's root
# Python's compiled bytecode, torch's included, in a fixed directory of the
# checkout (this process and the ranks it spawns), so that only a checkout's
# first run compiles it.
sys.dont_write_bytecode = False
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = os.path.join(sys.path[0], "benchmark", ".cache", "pycache")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    harness.pin_environment()
    import torch

    cell, _, _ = harness.resolve(harness.load_manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA cards, torch finds {found}", file=sys.stderr)
        return 1
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: modules loaded that the benchmark may not load: {found}", file=sys.stderr)
        return 1
    marks, compiled = result["setup"]["marks_s"], result["setup"]["compile_s"]
    print("setup, seconds from the start: " + ", ".join(f"{k} {v:.3f}" for k, v in marks.items())
          + f"; the build compiled {compiled:.3f}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
