"""The control of `correct`, on the cards: the plain reference with one
guarantee broken (reference/plain.py: a sort by the top 24 key bits, sums
in float32) stands in the program's place, through a short window of the
cell's own traffic, and the run's check must come out false.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 [--seconds 2]

Prints one line a seed: the numbers compared, each beside its limit, and
`correct` (false is the control's pass).
"""

import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_control():
    """Patches Workload.call to return the control's outputs for the step's
    pool entry (worked out once an entry); returns the undo."""
    from benchmark.workload import Workload

    original = Workload.call
    made = {}

    def call(self, step):
        key = (id(self), self.entry(step))
        if key not in made:
            made[key] = self.op.control(self.seed, self.entry(step), self.inputs[self.entry(step)])
        return made[key]

    Workload.call = call
    return lambda: setattr(Workload, "call", original)


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()

    from benchmark import harness

    harness.pin_environment()
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(args.workload, seed, args.seconds, False, t_start=time.time(),
                                  patch="benchmark.control:use_control")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "checks": result["checks"], "device": result["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
