"""The generator: the same seed gives the same inputs, every seed the same
pool lengths in another order, the key distributions are as named, and
what the generator does not know is refused."""

import pytest
import torch

from benchmark import harness, workload

CPU = torch.device("cpu")
SMALL = {"n_min": 1024, "n_max": 65536, "cards": 1}


def _traffic(name: str) -> dict:
    return harness.resolve(harness.load_manifest(), name)[2]


def test_same_seed_same_inputs_and_large_seeds():
    t = _traffic("u32_2p28_1card.sort_uniform")
    for seed in (0, 2**31 + 5, 2**33 + 1, -3):
        a = workload.Workload({"n": 4096, "cards": 1}, t, seed, CPU)
        b = workload.Workload({"n": 4096, "cards": 1}, t, seed, CPU)
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a.inputs[0], b.inputs[0]))
        assert a.sampled_steps() == b.sampled_steps()
    c = workload.Workload({"n": 4096, "cards": 1}, t, 2**31 + 6, CPU)
    assert not torch.equal(c.inputs[0][0].view(torch.int32), a.inputs[0][0].view(torch.int32))


def test_pool_same_lengths_in_another_order():
    t = _traffic("u32_small_1card.sort_closed")
    a = workload.Workload(SMALL, t, 1, CPU)
    b = workload.Workload(SMALL, t, 2, CPU)
    assert sorted(a.lengths) == sorted(b.lengths) and a.lengths != b.lengths
    assert len(a.lengths) == t["pool"] and min(a.lengths) == 1024 and max(a.lengths) == 65536
    assert [x[0].shape[0] for x in a.inputs] == a.lengths
    assert a.entry(t["pool"] + 3) == 3


def test_and_of_five_words_sets_a_bit_one_time_in_32():
    keys = workload.make({"dist": "and_words", "words": 5}, 1 << 16, workload.generator(CPU, 9), CPU)
    bits = torch.stack([(keys.view(torch.int32) >> b) & 1 for b in range(32)]).float().mean()
    assert abs(float(bits) - 1 / 32) < 0.002


def test_index_values_of_a_shard_are_its_global_positions():
    v = workload.make({"dist": "index"}, 8, None, CPU, start=16)
    assert v.view(torch.int32).tolist() == list(range(16, 24))
    counts = workload.make({"dist": "below", "high": 16}, 1000, workload.generator(CPU, 1), CPU)
    assert 0 <= int(counts.view(torch.int32).min()) and int(counts.view(torch.int32).max()) < 16


def test_unknown_distributions_and_ops_are_refused():
    with pytest.raises(KeyError, match="dists/no_such.py"):
        workload.make({"dist": "no_such"}, 4, None, CPU)
    with pytest.raises(KeyError, match="ops/no_such.py"):
        workload.op_class("no_such")
