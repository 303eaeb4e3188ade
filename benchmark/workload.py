"""The one generator: a cell's inputs, calls, reference and control, made
from its configuration and its traffic mix, both data.

A traffic mix names an `op` (what one step calls in the program), a `loop`
("stream": steps back to back with no wait; "closed": one caller that
waits for each result), the distributions its inputs are drawn from, and
for a closed loop a pool of inputs that the steps cycle through. The
configuration gives the sizes (`n`, or `n_min` to `n_max` for a pool) and
the cards. Every input is made on the device from the seed, in a few large
calls; the same seed gives the same inputs, and every seed gives a pool the
same set of lengths, in another order.

An op is the module `ops/<op>.py` and a distribution `dists/<dist>.py`,
found by name (plugins.py); a new op or distribution is a new file. An op's
`Op(traffic, rank, world)` has `limits` (each number its check gives, and
the most it may read), `make` (a pool entry's inputs), `call` (the
program, on the timed path), `reference` (the plain reference,
reference/), `control` (the reference with one stated guarantee broken,
in the program's place) and `check` (outputs against the reference, the
numbers of `limits`). A distribution's `make(spec, n, start, gen, device)`
gives n elements from the generator `gen`; `start` is the global position
of the first, for a rank's shard.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plugins

_ALL64 = (1 << 64) - 1


def derive_seed(*parts: int) -> int:
    """A 63-bit seed for torch.Generator from the run's seed and indices."""
    state = np.random.SeedSequence([int(p) & _ALL64 for p in parts]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def generator(device: torch.device, *parts: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(*parts))
    return gen


def words(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """n uniform 32-bit words, as int32."""
    return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=gen, device=device)


def make(spec: dict, n: int, gen: torch.Generator, device: torch.device, start: int = 0) -> torch.Tensor:
    """n elements of the distribution `spec` ({"dist": <name>, parameters})."""
    return plugins.load("dists", spec["dist"]).make(spec, n, start, gen, device)


def op_class(name: str):
    """The `Op` of ops/<name>.py."""
    return plugins.load("ops", name).Op


def pool_lengths(config: dict, traffic: dict) -> list[int]:
    """A closed loop's pool lengths: `pool` sizes spaced evenly in log2 from
    n_min to n_max, ends included. A stream has one length, `n`."""
    if traffic["loop"] != "closed":
        return [config["n"]]
    lo, hi, count = config["n_min"], config["n_max"], traffic["pool"]
    return [round(lo * (hi / lo) ** (i / (count - 1))) for i in range(count)]


class Workload:
    """One cell's traffic on one rank: the pool of inputs (one entry for a
    stream), the program's call for step i (entry i mod pool, in the
    seeded order), and the check of kept answers."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, rank: int = 0, world: int = 1):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.op = op_class(traffic["op"])(traffic, rank, world)
        lengths = pool_lengths(config, traffic)
        order = np.random.default_rng([seed & _ALL64, 1]).permutation(len(lengths))
        self.lengths = [lengths[i] for i in order]
        self.inputs = [self.op.make(seed, e, n, device) for e, n in enumerate(self.lengths)]
        self.work_per_step = [n * world for n in self.lengths]

    def entry(self, step: int) -> int:
        return step % len(self.lengths)

    def call(self, step: int) -> tuple:
        return self.op.call(self.inputs[self.entry(step)])

    def sampled_steps(self) -> set[int]:
        """Steps whose answers are kept and checked besides the last of each
        entry: `sampled_steps` drawn from the seed below `sample_within`."""
        rng = np.random.default_rng([self.seed & _ALL64, 2])
        within = self.traffic["sample_within"]
        return set(rng.choice(within, size=min(self.traffic["sampled_steps"], within), replace=False).tolist())

    def check(self, kept: dict) -> dict:
        """Sums over the kept answers ({step: outputs}) of each number the op
        compares, with "answers" (checked) and "wrong" (answers with any
        number over its limit)."""
        totals = dict.fromkeys(self.op.limits, 0)
        answers = wrong = 0
        by_entry: dict = {}
        for step, outputs in sorted(kept.items()):
            by_entry.setdefault(self.entry(step), []).append(outputs)
        for e, outs in sorted(by_entry.items()):
            fresh = self.op.make(self.seed, e, self.lengths[e], self.device)  # as made, whatever the program did
            ref = self.op.reference(self.seed, e, fresh)
            del fresh
            for outputs in outs:
                got = self.op.check(outputs, ref)
                answers += 1
                wrong += int(any(got[k] > self.op.limits[k] for k in got))
                for k, v in got.items():
                    totals[k] += v
            del ref
        return {"numbers": totals, "answers": answers, "wrong": wrong}
