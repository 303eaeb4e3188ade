"""The plain reference against the port at tiny sizes on the CPU (the
port's plain versions), and against an independent numpy sort."""

import numpy as np
import pytest
import torch

import glu_tpu_torch as glu
from benchmark import workload
from benchmark.reference import plain

CPU = torch.device("cpu")
INDEX = {"dist": "index"}
COUNTS = {"dist": "below", "high": 16}


@pytest.mark.parametrize("keys", [{"dist": "uniform"}, {"dist": "and_words", "words": 5}])
@pytest.mark.parametrize("n", [1, 2, 1000, 65536])
def test_sort_pairs_against_the_port_and_numpy(keys, n):
    gen = workload.generator(CPU, n)
    k = workload.make(keys, n, gen, CPU)
    v = workload.make(INDEX, n, gen, CPU)
    rk, rv = plain.sort_pairs(k, v)
    gk, gv = glu.radix_sort(k, v)
    assert plain.mismatches(gk, rk) == 0 and plain.mismatches(gv, rv) == 0
    order = np.argsort(k.view(torch.int32).numpy().view(np.uint32), kind="stable")
    assert rv.view(torch.int32).numpy().tolist() == order.tolist()


def test_scan_and_total_against_the_port_and_numpy():
    x = workload.make(COUNTS, 1 << 20, workload.generator(CPU, 3), CPU)
    big = torch.randint(-(2**31), 2**31, (4096,), dtype=torch.int32).view(torch.uint32)
    for v in (x, big):
        assert plain.mismatches(glu.exclusive_scan(v), plain.exclusive_sum(v)) == 0
        assert plain.mismatches(glu.reduce(v), plain.total(v)) == 0
        a = v.view(torch.int32).numpy().view(np.uint32).astype(np.uint64)
        want = ((np.cumsum(a) - a) % 2**32).astype(np.uint32)
        assert np.array_equal(plain.exclusive_sum(v).view(torch.int32).numpy().view(np.uint32), want)
        assert int(plain.total(v).view(torch.int32)) % 2**32 == int(a.sum() % 2**32)


def test_controls_break_their_guarantee():
    k = workload.make({"dist": "uniform"}, 1 << 16, workload.generator(CPU, 4), CPU)
    v = workload.make(INDEX, 1 << 16, None, CPU)
    assert plain.mismatches(plain.sort_pairs(k, v, drop_bits=8)[0], plain.sort_pairs(k, v)[0]) > 0
    x = workload.make(COUNTS, 1 << 22, workload.generator(CPU, 5), CPU)
    assert plain.mismatches(plain.exclusive_sum_float32(x), plain.exclusive_sum(x)) > 0


def test_mismatches_counts_lengths():
    a = torch.arange(10, dtype=torch.int32).view(torch.uint32)
    assert plain.mismatches(a, a) == 0 and plain.mismatches(a[:6], a) == 4
    assert plain.mismatches(a.view(torch.int32).flip(0).view(torch.uint32), a) == 10
