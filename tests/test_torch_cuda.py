"""Tests that need an NVIDIA GPU (marker `cuda`): each hand-written kernel
(glu_tpu_torch/csrc/*.cu) against its plain torch version on the card, the
whole sort against one stable torch.sort, and the reduce and scan entry
points against their "torch" backend. Integers bit for bit; floats at
rtol 1e-4, atol 1e-3 (sums are taken in another order). A CUDA kernel has no
CPU mode, so they skip where torch.cuda.is_available() is false. This file
imports no JAX; on a GPU machine without it, run

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

import glu_tpu_torch
from glu_tpu_torch import ReduceOperator
from glu_tpu_torch.ops import _cuda_reduce as cr
from glu_tpu_torch.ops import _cuda_scan as csc
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


def _onesweep_on_card(keys, pays, positions):
    """digit_histograms and onesweep_pass against their plain versions;
    returns the pass's launches of each kernel."""
    before = cs.launch_counts()
    hist = cs.digit_histograms(keys, [positions])
    _assert_same([hist], [cs.digit_histograms_ref(keys, [positions])])
    base = (torch.cumsum(hist, 1, dtype=torch.int32) - hist)[0, : 1 << len(positions)]
    got = cs.onesweep_pass(keys, pays, positions, base)
    want = cs.onesweep_pass_ref(keys, pays, positions, base)
    _assert_same([got[0], *got[1]], [want[0], *want[1]])
    after = cs.launch_counts()
    return after["digit_histograms"] - before["digit_histograms"], after["onesweep_pass"] - before["onesweep_pass"]


@pytest.mark.parametrize("streams", [0, 1])
@pytest.mark.parametrize("positions", [(0, 1, 2, 3), (8,), (26, 27, 28, 29, 30, 31)])
@pytest.mark.parametrize("kind", ["uniform", "constant", "mod3"])
def test_onesweep_kernels_match_plain(dev, kind, positions, streams):
    n = 3 * cs.TILE + 777  # three full tiles and a ragged tail
    keys = _words(kind, n, dev)
    pays = [torch.arange(n, dtype=torch.int32, device=dev)][:streams]
    assert _onesweep_on_card(keys, pays, positions) == (1, 1)


@pytest.mark.parametrize("n", [3 * 4096 + 777, 4096, 1_000_003])
@pytest.mark.parametrize("positions", [tuple(range(8)), tuple(range(24, 32)), (30, 3, 17, 9, 0, 22, 5, 12)])
@pytest.mark.parametrize("kind", ["uniform", "constant", "mod3"])
def test_onesweep_kernels_match_plain_8_bits(dev, kind, positions, n):
    # 8-bit digits (256 bins), non-contiguous ones, a single tile and many;
    # 7 payload streams, the most a pass takes
    keys = _words(kind, n, dev)
    pays = [torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev) for _ in range(7)]
    assert _onesweep_on_card(keys, pays, positions) == (1, 1)


def test_digit_histograms_every_pass_at_once(dev):
    keys = _words("uniform", 1_000_003, dev)
    groups = [tuple(range(0, 8)), tuple(range(8, 16)), tuple(range(16, 24)), (31, 25, 27)]
    _assert_same([cs.digit_histograms(keys, groups)], [cs.digit_histograms_ref(keys, groups)])
    # an odd offset: the kernels take the words one at a time there
    k = keys[1:]
    v = _words("mod3", 1_000_005, dev)[3 : 3 + k.numel()]
    hist = cs.digit_histograms(k, [tuple(range(8))])
    _assert_same([hist], [cs.digit_histograms_ref(k, [tuple(range(8))])])
    base = (torch.cumsum(hist, 1, dtype=torch.int32) - hist)[0]
    got = cs.onesweep_pass(k, [v], tuple(range(8)), base)
    want = cs.onesweep_pass_ref(k, [v], tuple(range(8)), base)
    _assert_same([got[0], *got[1]], [want[0], *want[1]])


@pytest.mark.parametrize("positions", [tuple(range(32)), tuple(range(12)), tuple(range(24, 32)), (31, 0, 17, 5, 9)])
@pytest.mark.parametrize("n", [1, 2, 1000, 10000, cs.SINGLE_TILE_MAX])
def test_sort_single_tile_matches_plain(dev, n, positions):
    # 4 passes of 8 bits, 8 + 4, the top byte, 5 scattered bits; 0, 1 and 7
    # payload streams (the most a sort takes)
    for kind in ("uniform", "constant", "mod3"):
        keys = _words(kind, n, dev)
        for streams in (0, 1, 7):
            pays = [torch.arange(n, dtype=torch.int32, device=dev)]
            pays += [torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev) for _ in range(6)]
            pays = pays[:streams]
            before = cs.launch_counts()["sort_single_tile"]
            got = cs.sort_single_tile(keys, pays, positions)
            assert cs.launch_counts()["sort_single_tile"] - before == 1
            want = cs.sort_single_tile_ref(keys, pays, positions)
            _assert_same([got[0], *got[1]], [want[0], *want[1]])


@pytest.mark.parametrize("n,calls", [(cs.SINGLE_TILE_MAX, (0, 0, 1)), (cs.SINGLE_TILE_MAX + 1, (1, 4, 0))])
def test_radix_sort_at_the_single_tile_limit(dev, n, calls):
    # K3 alone up to its limit, one element more takes 1 histogram + 4 passes
    keys = _words("uniform", n, dev).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    before = cs.launch_counts()
    out_k, out_v = glu_tpu_torch.radix_sort(keys, vals)
    after = cs.launch_counts()
    ref_k, ref_v = glu_tpu_torch.radix_sort(keys, vals, backend="torch")
    _assert_same([out_k.view(torch.int32), out_v.view(torch.int32)],
                 [ref_k.view(torch.int32), ref_v.view(torch.int32)])
    assert tuple(after[k] - before[k] for k in ("digit_histograms", "onesweep_pass", "sort_single_tile")) == calls


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
    assert after["digit_histograms"] - before["digit_histograms"] == 1
    assert after["onesweep_pass"] - before["onesweep_pass"] == 4
    assert after["sort_single_tile"] - before["sort_single_tile"] == 0


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


KERNEL_DTYPES = [torch.int32, torch.uint32, torch.float32, torch.float64]
# ragged, one tile, 100 partitions of 1000, the UVEC4 layout (4 partitions),
# the sort's [digit][tile] table (16 x 65536)
FOLD_SHAPES = [(1, 1), (1, 4097), (1, 100_003), (100, 1000), (4, 65_539), (16, 65_536)]


def _fold_input(dtype, op, shape, dev) -> torch.Tensor:
    """Seeded values that keep every prefix meaningful: odd integer factors
    for MUL, factors near 1 for float MUL, positive float addends (no
    cancellation), and a NaN in row 0 for float MIN/MAX."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1] + op.value)
    n = shape[0] * shape[1]
    if dtype.is_floating_point:
        if op == ReduceOperator.SUM:
            a = rng.uniform(0, 1, n)
        elif op == ReduceOperator.MUL:
            a = np.exp(rng.normal(0, 1e-3, n))
        else:
            a = rng.uniform(-1, 1, n)
            a[shape[1] // 3] = np.nan
        t = torch.from_numpy(a).to(dtype)
    else:
        a = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        if op == ReduceOperator.MUL:
            a |= 1
        t = torch.from_numpy(a.view(np.int32))
        t = t.view(torch.uint32) if dtype == torch.uint32 else t
    return t.reshape(shape).to(dev)


def _assert_close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3, equal_nan=True)
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape", FOLD_SHAPES)
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("op", list(ReduceOperator))
def test_reduce_partitions_match_plain(dev, op, dtype, shape):
    x = _fold_input(dtype, op, shape, dev)
    before = cr.launch_counts()["reduce"]
    got = cr.reduce_partitions(x, op)
    assert cr.launch_counts()["reduce"] - before == 2
    _assert_close(got, cr.reduce_partitions_ref(x, op))


@pytest.mark.parametrize("shape", FOLD_SHAPES)
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("op", list(ReduceOperator))
def test_exclusive_scan_partitions_match_plain(dev, op, dtype, shape):
    x = _fold_input(dtype, op, shape, dev)
    before = csc.launch_counts()["exclusive_scan"]
    got = csc.exclusive_scan_partitions(x, op)
    assert csc.launch_counts()["exclusive_scan"] - before == (1 if shape[1] <= csc.TILE else 3)
    _assert_close(got, csc.exclusive_scan_partitions_ref(x, op))


@pytest.mark.parametrize("op", list(ReduceOperator))
def test_reduce_and_scan_entry_points_match_torch(dev, op):
    # the public entry points, "cuda" against "torch", on scalars and on
    # the (N, 4) layout of UVEC4
    for shape in [(1 << 20,), (100_003, 4)]:
        x = _fold_input(torch.uint32, op, (1, int(np.prod(shape))), dev).reshape(shape)
        _assert_close(glu_tpu_torch.reduce(x, op), glu_tpu_torch.reduce(x, op, backend="torch"))
        for fn in (glu_tpu_torch.exclusive_scan, glu_tpu_torch.inclusive_scan):
            _assert_close(fn(x, op=op), fn(x, op=op, backend="torch"))
    n = 1 << 20
    x = _fold_input(torch.uint32, op, (1, n), dev).reshape(n)
    cuts = np.sort(np.random.default_rng(op.value).integers(0, n + 1, 999))
    offs = torch.from_numpy(np.concatenate([[0], cuts, [n]])).to(dev)
    _assert_close(glu_tpu_torch.segmented_reduce(x, offs, op), glu_tpu_torch.segmented_reduce(x, offs, op, backend="torch"))
    _assert_close(glu_tpu_torch.exclusive_scan(x, op=op, offsets=offs),
                  glu_tpu_torch.exclusive_scan(x, op=op, offsets=offs, backend="torch"))


def test_reduce_and_scan_classes_on_default_device(dev):
    # DeviceBuffer(numpy) goes to the card by default; the classes work in place
    data = np.random.default_rng(5).integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    buf = glu_tpu_torch.DeviceBuffer(data)
    assert buf.device.type == "cuda"
    glu_tpu_torch.BlellochScan(glu_tpu_torch.DataType.UINT)(buf, 1 << 15, 2)
    want = np.concatenate([np.cumsum(p, dtype=np.uint32) - p for p in data.reshape(2, -1)])
    np.testing.assert_array_equal(buf.get_data(), want)
    buf = glu_tpu_torch.DeviceBuffer(data)
    result = glu_tpu_torch.Reduce(glu_tpu_torch.DataType.UINT, ReduceOperator.MAX)(buf, 1000)
    assert int(result) == int(data[:1000].max()) == int(buf.get_data()[0])
    np.testing.assert_array_equal(buf.get_data()[1:], data[1:])
