"""One step: `glu_tpu_torch.radix_sort(keys, values)`, default (routed)
backend; keys and values come from the traffic's `keys` and `values`
distributions. The check: keys and values, bit for bit, against a stable
sort by the whole key."""

from benchmark import workload
from benchmark.reference import plain


class Op:
    limits = {"key_mismatches": 0, "value_mismatches": 0}

    def __init__(self, traffic: dict, rank: int, world: int):
        self.traffic = traffic

    def make(self, seed: int, entry: int, n: int, device) -> tuple:
        gen = workload.generator(device, seed, 0, entry)
        return workload.make(self.traffic["keys"], n, gen, device), workload.make(self.traffic["values"], n, gen, device)

    def call(self, inputs: tuple) -> tuple:
        import glu_tpu_torch as glu

        return glu.radix_sort(*inputs)

    def reference(self, seed: int, entry: int, inputs: tuple) -> tuple:
        return plain.sort_pairs(*inputs)

    def control(self, seed: int, entry: int, inputs: tuple) -> tuple:
        """A sort by the top 24 key bits: one 8-bit pass of four left out."""
        return plain.sort_pairs(*inputs, drop_bits=8)

    def check(self, outputs: tuple, ref: tuple) -> dict:
        return {"key_mismatches": plain.mismatches(outputs[0], ref[0]),
                "value_mismatches": plain.mismatches(outputs[1], ref[1])}
