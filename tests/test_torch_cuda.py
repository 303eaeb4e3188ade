"""Tests that need an NVIDIA GPU (marker `cuda`): each hand-written kernel
(glu_tpu_torch/csrc/radix_sort.cu) against its plain torch version on the
card, bit for bit, and the whole sort against one stable torch.sort. A CUDA
kernel has no CPU mode, so they skip where torch.cuda.is_available() is
false. This file imports no JAX; on a GPU machine without it, run

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

import glu_tpu_torch
from glu_tpu_torch.ops import _cuda_sort as cs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _words(kind: str, n: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(n)
    if kind == "uniform":
        a = rng.integers(0, 2**32, n, dtype=np.uint32)
    elif kind == "constant":
        a = np.full(n, 0x5EADBEEF, dtype=np.uint32)
    else:
        a = rng.integers(0, 3, n).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


def _assert_same(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("streams", [0, 1])
@pytest.mark.parametrize("positions", [(0, 1, 2, 3), (8,), (26, 27, 28, 29, 30, 31)])
@pytest.mark.parametrize("kind", ["uniform", "constant", "mod3"])
def test_group_tiles_and_scatter_runs_match_plain(dev, kind, positions, streams):
    n = 3 * cs.TILE + 777  # three full tiles and a ragged tail
    keys = _words(kind, n, dev)
    pays = [torch.arange(n, dtype=torch.int32, device=dev)][:streams]
    before = cs.launch_counts()
    gk, gp, counts = cs.group_tiles(keys, pays, positions)
    rk, rp, rc = cs.group_tiles_ref(keys, pays, positions)
    _assert_same([gk, *gp, counts], [rk, *rp, rc])
    offsets = cs.run_offsets(counts)
    sk, sp = cs.scatter_runs(gk, gp, counts, offsets, positions)
    rk, rp = cs.scatter_runs_ref(gk, gp, counts, offsets, positions)
    _assert_same([sk, *sp], [rk, *rp])
    after = cs.launch_counts()
    assert after["group_tiles"] - before["group_tiles"] == 1
    assert after["scatter_runs"] - before["scatter_runs"] == 1


@pytest.mark.parametrize("positions", [tuple(range(32)), (31, 0, 17, 5, 9)])
@pytest.mark.parametrize("n", [1, 2, 1000, 10000, cs.SINGLE_TILE_MAX])
def test_sort_single_tile_matches_plain(dev, n, positions):
    for kind in ("uniform", "mod3"):
        keys = _words(kind, n, dev)
        for streams in (0, 1):
            pays = [torch.arange(n, dtype=torch.int32, device=dev)][:streams]
            got = cs.sort_single_tile(keys, pays, positions)
            want = cs.sort_single_tile_ref(keys, pays, positions)
            _assert_same([got[0], *got[1]], [want[0], *want[1]])


@pytest.mark.parametrize("n", [100_003, 1 << 20])
def test_radix_sort_matches_torch_sort(dev, n):
    keys = _words("uniform", n, dev).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    before = cs.launch_counts()
    out_k, out_v = glu_tpu_torch.radix_sort(keys, vals)
    after = cs.launch_counts()
    ref_k, ref_v = glu_tpu_torch.radix_sort(keys, vals, backend="torch")
    _assert_same([out_k.view(torch.int32), out_v.view(torch.int32)],
                 [ref_k.view(torch.int32), ref_v.view(torch.int32)])
    assert after["group_tiles"] - before["group_tiles"] == 8
    assert after["scatter_runs"] - before["scatter_runs"] == 8


def test_buffers_and_timing_on_card(dev):
    from glu_tpu_torch.utils.timing import measure_elapsed_time

    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    t = glu_tpu_torch.from_numpy(a, dev)
    assert t.is_cuda and t.dtype == torch.uint32
    np.testing.assert_array_equal(glu_tpu_torch.to_numpy(t), a)
    buf = glu_tpu_torch.DeviceBuffer(size=4, device=dev)
    buf.write_data(a[:3])
    buf.resize(6, keep_data=True)
    np.testing.assert_array_equal(buf.get_data(), [0, 1, 0x7FFFFFFF, 0, 0, 0])
    buf.clear(0xFFFFFFFE)
    np.testing.assert_array_equal(buf.get_data(), [0xFFFFFFFE] * 6)
    copy = glu_tpu_torch.copy_buffer(t, 7)
    np.testing.assert_array_equal(glu_tpu_torch.to_numpy(copy), np.r_[a, 0, 0])
    ns, result = measure_elapsed_time(lambda: torch.ones(1 << 20, device=dev).sum(), dev)
    assert ns > 0 and int(result) == 1 << 20


def test_radix_sort_class_on_card(dev):
    n = 50_000
    keys = np.random.default_rng(3).integers(0, 2**32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    kbuf = glu_tpu_torch.DeviceBuffer(keys, device=dev)
    vbuf = glu_tpu_torch.DeviceBuffer(vals, device=dev)
    sorter = glu_tpu_torch.RadixSort()
    sorter.prepare_internal_buffers(n, device=dev)
    sorter(kbuf, vbuf, n - 7)
    order = np.argsort(keys[: n - 7], kind="stable")
    np.testing.assert_array_equal(kbuf.get_data(), np.r_[keys[order], keys[n - 7:]])
    np.testing.assert_array_equal(vbuf.get_data(), np.r_[order, vals[n - 7:]])
