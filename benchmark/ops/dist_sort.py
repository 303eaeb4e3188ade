"""One step on every rank: `glu_tpu_torch.parallel.distributed_radix_sort(
keys, values)` with its defaults on this rank's shard of a global array.
Rank r's shard is made from (seed, r), its values from the `values`
distribution at the global start r * n. The reference and the control
make every rank's shard again and sort the whole array; each rank is held
to its slice."""

import torch

from benchmark import plugins, workload
from benchmark.reference import plain


class Op(plugins.load("ops", "sort").Op):
    limits = {"key_mismatches": 0, "value_mismatches": 0, "count_errors": 0}

    def __init__(self, traffic: dict, rank: int, world: int):
        super().__init__(traffic, rank, world)
        self.rank, self.world = rank, world

    def _shard(self, seed: int, r: int, n: int, device) -> tuple:
        gen = workload.generator(device, seed, r, 0)
        return (workload.make(self.traffic["keys"], n, gen, device),
                workload.make(self.traffic["values"], n, gen, device, start=r * n))

    def make(self, seed: int, entry: int, n: int, device) -> tuple:
        return self._shard(seed, self.rank, n, device)

    def call(self, inputs: tuple) -> tuple:
        from glu_tpu_torch import parallel

        return parallel.distributed_radix_sort(*inputs)

    def _global_sort(self, seed: int, inputs: tuple, drop_bits: int) -> tuple:
        n, device = inputs[0].shape[0], inputs[0].device
        shards = [self._shard(seed, r, n, device) for r in range(self.world)]
        keys = torch.cat([s[0].view(torch.int32) for s in shards]).view(torch.uint32)
        values = torch.cat([s[1].view(torch.int32) for s in shards]).view(torch.uint32)
        del shards
        return plain.sort_pairs(keys, values, drop_bits)

    def reference(self, seed: int, entry: int, inputs: tuple) -> tuple:
        return self._global_sort(seed, inputs, 0)

    def control(self, seed: int, entry: int, inputs: tuple) -> tuple:
        """The control's global order (the top 24 key bits), cut into equal
        slices a rank."""
        keys, values = self._global_sort(seed, inputs, 8)
        n = inputs[0].shape[0]
        mine = slice(self.rank * n, (self.rank + 1) * n)
        counts = torch.full((self.world,), n, dtype=torch.int32, device=keys.device)
        return keys[mine], values[mine], counts, torch.zeros_like(counts)

    def check(self, outputs: tuple, ref: tuple) -> dict:
        """This rank's keys and values against its slice of the global
        order, the slice starting at the sum of the counts of the ranks
        before it; a count error for counts that differ between ranks, do
        not add up to the whole, or do not match this rank's length."""
        import torch.distributed as dist

        keys, values, counts = outputs[0], outputs[1], outputs[2].to(torch.int64)
        every = [torch.empty_like(counts) for _ in range(self.world)]
        dist.all_gather(every, counts)
        errors = sum(int(not torch.equal(c, counts)) for c in every)
        errors += int(int(counts.sum()) != ref[0].shape[0]) + int(int(counts[self.rank]) != keys.shape[0])
        start = int(counts[: self.rank].sum())
        mine = slice(start, start + int(counts[self.rank]))
        return {"key_mismatches": plain.mismatches(keys, ref[0][mine]),
                "value_mismatches": plain.mismatches(values, ref[1][mine]), "count_errors": errors}
