"""Graph 500's kernel 1 on the port, on the CPU: the Kronecker generator of
the benchmark's Graph 500 cell (benchmark/dists/kronecker.py) draws its
quadrants with the specification's probabilities; the cell's CSR build
(benchmark/ops/csr_build.py: the u64 two-word sort, a bincount and the
exclusive scan) equals ref_csr bit for bit on both backends, a planted
multi-edge keeping its input order; and the two-word chain's counters and
spans (sort.two_word, sort.two_word_passes, glu.two_word.minor and .major)
move on the engine's branch of the u64 and segmented sorts and stay still
on "torch"."""

import numpy as np
import pytest
import torch

import glu_tpu_torch as glu
from benchmark import plugins, workload
from glu_tpu_torch.ops.reference import ref_csr
from glu_tpu_torch.utils import timing

CPU = torch.device("cpu")
SPEC = {"dist": "kronecker", "a": 0.57, "b": 0.19, "c": 0.19, "edgefactor": 16}
KRONECKER = plugins.load("dists", "kronecker")
COUNTERS = ("sort.two_word", "sort.two_word_passes")


@pytest.fixture(autouse=True)
def store():
    timing.reset()
    yield
    timing.disable()
    timing.reset()


def test_quadrant_shares_are_a_b_c_and_d_and_ids_fit_the_scale():
    scale, n = 10, 1 << 14
    ij = KRONECKER.quadrants(SPEC, n, scale, workload.generator(CPU, 20), CPU)
    bits = torch.stack([(ij >> level) & 1 for level in range(scale)])  # (level, src or dst, edge)
    quadrant = (2 * bits[:, 0] + bits[:, 1]).flatten()
    shares = torch.bincount(quadrant, minlength=4).double() / quadrant.numel()
    want = torch.tensor([SPEC["a"], SPEC["b"], SPEC["c"], 1 - SPEC["a"] - SPEC["b"] - SPEC["c"]], dtype=torch.float64)
    sigma = (want * (1 - want) / quadrant.numel()).sqrt()
    assert ((shares - want).abs() < 5 * sigma).all(), (shares, want)
    edges = KRONECKER.make(SPEC, n, 0, workload.generator(CPU, 21), CPU).view(torch.int32)
    assert edges.shape == (2, n) and int(edges.min()) >= 0 and int(edges.max()) < 1 << scale
    assert KRONECKER.scale_of(SPEC, n) == scale
    with pytest.raises(ValueError):
        KRONECKER.scale_of(SPEC, 3 * n)


def _op():
    traffic = {"op": "csr_build", "edges": SPEC}
    return workload.op_class("csr_build")(traffic, 0, 1)


def _plant_multi_edge(inputs: tuple, positions: list) -> tuple:
    """The edge at positions[0] copied to the other positions, each copy
    with a weight of its own: the copies' weights, in input order."""
    src, dst, weights = (t.view(torch.int32).clone() for t in inputs)
    p = torch.tensor(positions)
    src[p], dst[p] = int(src[positions[0]]), int(dst[positions[0]])
    weights[p] = torch.arange(len(positions), dtype=torch.int32) + 7
    return tuple(t.view(torch.uint32) for t in (src, dst, weights))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("scale", [8, 12, 13])  # K3 up to 2^16 edges; the plain onesweep passes above
def test_the_csr_build_equals_ref_csr(monkeypatch, backend, scale):
    monkeypatch.setenv("GLU_TPU_TORCH_BACKEND", backend)
    op, n = _op(), SPEC["edgefactor"] << scale
    positions = [n - 1, 3, n // 2, 5]
    inputs = _plant_multi_edge(op.make(2**33 + scale, 0, n, CPU), positions)
    starts, columns, weights = op.call(inputs)
    want = ref_csr(*inputs, 1 << scale)
    for got, w in zip((starts, columns, weights), want):
        assert got.dtype == w.dtype and torch.equal(got.view(torch.int32), w.view(torch.int32))
    assert starts.dtype == torch.int32 and starts.shape == (1 << scale,)
    row = int(inputs[0].view(torch.int32)[positions[0]])
    end = int(starts[row + 1]) if row + 1 < 1 << scale else n
    mine = weights.view(torch.int32)[int(starts[row]) : end]
    copies = mine[(mine >= 7) & (mine < 7 + len(positions))].tolist()
    assert copies == [7 + i for i in np.argsort(positions, kind="stable")]  # the copies in input order
    assert timing.summary()["counters"]["sort.two_word"] == (backend == "cuda")


def _u32(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32).view(np.int32)).view(
        torch.uint32)


def _u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([lo.view(torch.int32), hi.view(torch.int32)], 1).view(torch.uint64).view(-1)


@pytest.mark.parametrize("n", [1000, 20_000, 70_004])  # one CTA, a cluster, the onesweep passes
@pytest.mark.parametrize("sort, passes", [
    pytest.param(lambda k, v, b: glu.radix_sort_u64_parts(k, v, v, backend=b), 8, id="u64-parts"),
    pytest.param(lambda k, v, b: glu.radix_sort_u64_parts(k, v, v, backend=b, bits=(range(12), range(4))), 3,
                 id="u64-parts-bits"),
    pytest.param(lambda k, v, b: glu.radix_sort_u64(_u64(k, v), v, backend=b), 8, id="u64"),
    pytest.param(lambda k, v, b: glu.radix_sort_segmented(k, v, num_partitions=4, backend=b), 5, id="segmented"),
])
def test_two_word_counters_and_spans_move_on_the_engine_alone(sort, passes, n):
    k, v = _u32(n, 1), _u32(n, 2)
    timing.enable()
    sort(k, v, "torch")
    summary = timing.summary()
    assert all(summary["counters"][c] == 0 for c in COUNTERS)  # listed before they count
    assert not any(name.startswith("glu.two_word") for name in summary["spans"])
    for _ in range(2):
        sort(k, v, "cuda")
    summary = timing.summary()
    assert summary["counters"]["sort.two_word"] == 2 and summary["counters"]["sort.two_word_passes"] == 2 * passes
    assert summary["spans"]["glu.two_word.minor"]["count"] == 2 == summary["spans"]["glu.two_word.major"]["count"]
    records = timing.records()
    for r in records:
        if r.name.startswith("glu.two_word"):
            assert records[r.parent].name.startswith("glu.radix_sort")
