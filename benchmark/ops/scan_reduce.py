"""One step: `glu_tpu_torch.exclusive_scan(v)`, then `glu_tpu_torch.reduce(v)`
of the same array, default backends; v from the traffic's `values`
distribution. The check: the scan and the total, bit for bit, against sums
in int64 wrapped to 32 bits."""

from benchmark import workload
from benchmark.reference import plain


class Op:
    limits = {"scan_mismatches": 0, "reduce_mismatches": 0}

    def __init__(self, traffic: dict, rank: int, world: int):
        self.traffic = traffic

    def make(self, seed: int, entry: int, n: int, device) -> tuple:
        return (workload.make(self.traffic["values"], n, workload.generator(device, seed, 0, entry), device),)

    def call(self, inputs: tuple) -> tuple:
        import glu_tpu_torch as glu

        return glu.exclusive_scan(inputs[0]), glu.reduce(inputs[0])

    def reference(self, seed: int, entry: int, inputs: tuple) -> tuple:
        return plain.exclusive_sum(inputs[0]), plain.total(inputs[0])

    def control(self, seed: int, entry: int, inputs: tuple) -> tuple:
        """The scan and the total accumulated in float32."""
        return plain.exclusive_sum_float32(inputs[0]), plain.total_float32(inputs[0])

    def check(self, outputs: tuple, ref: tuple) -> dict:
        return {"scan_mismatches": plain.mismatches(outputs[0], ref[0]),
                "reduce_mismatches": plain.mismatches(outputs[1], ref[1])}
