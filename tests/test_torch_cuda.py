"""Tests that need an NVIDIA GPU (marker `cuda`): each hand-written kernel
(glu_tpu_torch/csrc/*.cu) against its plain torch version on the card, the
whole sort against one stable torch.sort, the reduce and scan entry
points against their "torch" backend, the distributed layer on a
1-rank NCCL group against the single-card calls, and its bucket kernel KB
against its plain version at chip_smoke.py phase 11's shapes. Integers bit for bit; floats at
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


@pytest.mark.parametrize("n", [3 * cs.TILE + 777, (1 << 26) + 3])
@pytest.mark.parametrize("positions", [tuple(range(32)), tuple(range(8)), (30, 3, 17, 9, 0, 22, 5, 12, 31)])
@pytest.mark.parametrize("streams", [0, 1, 7])
def test_onesweep_sort_matches_the_per_pass_wrappers(dev, streams, positions, n):
    # the one-call sort (the histogram's last CTA writes the digit starts,
    # the passes write the outputs and a scratch buffer in turn; at 2^26
    # pairs and 4 passes one status region zeroed a pass) against
    # digit_histograms and onesweep_pass, pass by pass; the inputs unwritten
    keys = _words("uniform", n, dev)
    pays = [torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev) for _ in range(streams)]
    kept = [keys.clone(), *(p.clone() for p in pays)]
    before = cs.launch_counts()
    got_k, got_p = cs.onesweep_sort(keys, pays, positions)
    after = cs.launch_counts()
    groups = cs._pass_groups(positions)
    assert (after["digit_histograms"] - before["digit_histograms"], after["onesweep_pass"] - before["onesweep_pass"]) \
        == (1, len(groups))
    hist = cs.digit_histograms(keys, groups)
    want_k, want_p = keys, pays
    for g, base in zip(groups, torch.cumsum(hist, 1, dtype=torch.int32) - hist):
        want_k, want_p = cs.onesweep_pass(want_k, want_p, g, base[: 1 << len(g)])
    _assert_same([got_k, *got_p], [want_k, *want_p])
    _assert_same([keys, *pays], kept)


def test_onesweep_ctas_per_sm_on_the_h100(dev):
    # the pass asks for 2 CTAs an SM (its registers hold it there whatever
    # the shared memory allows); 8 streams' tiles fill an SM's shared memory
    lib = cs._sort_lib()
    got = {s: lib.glu_onesweep_ctas_per_sm(s) for s in (1, 2, 3, 8)}
    assert got == {1: 2, 2: 2, 3: 2, 8: 1}, got
    assert lib.glu_onesweep_ctas_per_sm(0) < 0 and lib.glu_onesweep_ctas_per_sm(cs.MAX_STREAMS + 1) < 0


def _onesweep_sort_ref(keys, pays, positions):
    """The plain version of onesweep_sort, pass by pass, on the card's tensors."""
    groups = cs._pass_groups(positions)
    hist = cs.digit_histograms_ref(keys, groups)
    for g, base in zip(groups, torch.cumsum(hist, 1, dtype=torch.int32) - hist):
        keys, pays = cs.onesweep_pass_ref(keys, pays, g, base[: 1 << len(g)])
    return keys, pays


@pytest.mark.parametrize("streams", [0, 1, 2, 7])
def test_onesweep_sort_matches_plain_across_resident_ctas(dev, streams):
    # 2^24 + 17 pairs: 2,731 tiles, so the look-back walks across the tiles
    # of every CTA in flight, and the last tile is ragged
    n = (1 << 24) + 17
    keys = _words("mod3" if streams == 2 else "uniform", n, dev)
    pays = [torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev) for _ in range(streams)]
    positions = tuple(range(32))
    got_k, got_p = cs.onesweep_sort(keys, pays, positions)
    want_k, want_p = _onesweep_sort_ref(keys, pays, positions)
    _assert_same([got_k, *got_p], [want_k, *want_p])


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
@pytest.mark.parametrize("n", [1, 2, 1000, cs.CTA_MAX, cs.CTA_MAX + 1, 10000, 24576, 24577, 32768, 49153, 65535,
                               cs.SINGLE_TILE_MAX])
def test_sort_single_tile_matches_plain(dev, n, positions):
    # 4 passes of 8 bits, 8 + 4, the top byte, 5 scattered bits; 0, 1 and 7
    # payload streams (the most a sort takes); one CTA up to CTA_MAX, a
    # cluster above
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


@pytest.mark.parametrize("n,ctas", [(n, c) for n in (cs.SLICE_MAX, 49153, cs.SINGLE_TILE_MAX)
                                    for c in range(1, cs.MAX_CLUSTER + 1) if cs.single_tile_slice(n, c) <= cs.SLICE_MAX])
def test_sort_single_tile_on_every_cluster(dev, n, ctas):
    # K3 on each CTA count that holds n, one CTA and every cluster (the
    # slices ragged at 49,153), against its plain version
    keys = _words("uniform", n, dev)
    pays = [torch.arange(n, dtype=torch.int32, device=dev), _words("mod3", n, dev)]
    for positions in (tuple(range(32)), (31, 0, 17, 5, 9)):
        got = cs.sort_single_tile(keys, pays, positions, ctas=ctas)
        want = cs.sort_single_tile_ref(keys, pays, positions)
        _assert_same([got[0], *got[1]], [want[0], *want[1]])


def test_sort_single_tile_refused_launch_raises(dev):
    # a launch the C entry refuses (65,536 elements on 2 CTAs: slices over
    # SLICE_MAX) raises GluError through the wrapper's error check,
    # uncounted
    keys = _words("uniform", cs.SINGLE_TILE_MAX, dev)
    before = cs.launch_counts()["sort_single_tile"]
    with pytest.raises(glu_tpu_torch.GluError, match="glu_sort_single_tile failed"):
        cs._launch("glu_sort_single_tile", dev, cs._pointers([keys]), cs._pointers([torch.empty_like(keys)]), 1,
                   keys.numel(), *cs._single_tile_plan(tuple(range(32)))[1], 2)
    assert cs.launch_counts()["sort_single_tile"] == before
    assert all(cs._sort_lib().glu_sort_single_tile_clusters(c) >= 1 for c in range(2, cs.MAX_CLUSTER + 1))


@pytest.mark.parametrize("n,calls", [(cs.SINGLE_TILE_MAX, (0, 0, 1)), (cs.SINGLE_TILE_MAX + 1, (1, 4, 0))])
def test_radix_sort_at_the_single_tile_limit(dev, n, calls):
    # K3 alone up to its limit, one element more takes 1 histogram + 4 passes
    keys = _words("uniform", n, dev).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    before = cs.launch_counts()
    out_k, out_v = glu_tpu_torch.radix_sort(keys, vals, backend="cuda")
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
    out_k, out_v = glu_tpu_torch.radix_sort(keys, vals, backend="cuda")
    after = cs.launch_counts()
    ref_k, ref_v = glu_tpu_torch.radix_sort(keys, vals, backend="torch")
    _assert_same([out_k.view(torch.int32), out_v.view(torch.int32)],
                 [ref_k.view(torch.int32), ref_v.view(torch.int32)])
    assert after["digit_histograms"] - before["digit_histograms"] == 1
    assert after["onesweep_pass"] - before["onesweep_pass"] == 4
    assert after["sort_single_tile"] - before["sort_single_tile"] == 0


@pytest.fixture
def shipped_table(monkeypatch, tmp_path):
    """The router on the shipped table (no calibration file), read as a
    routed call reads it, and no override."""
    from glu_tpu_torch.ops import router

    monkeypatch.setenv("GLU_TPU_TORCH_ROUTER_CALIBRATION", str(tmp_path / "absent.json"))
    monkeypatch.delenv("GLU_TPU_TORCH_BACKEND", raising=False)
    router._reset_router_model()
    yield router
    router._reset_router_model()


@pytest.mark.parametrize("n,route", [(49_152, "cuda"), (1 << 22, "cuda"), (1 << 24, "cuda")])
def test_routed_radix_sort_launches(dev, shipped_table, n, route):
    # backend=None launches what the shipped table's route says: on the
    # H100 the engine at every size, K3 up to SINGLE_TILE_MAX (a cluster
    # above CTA_MAX) and 1 + 4 launches above (one library call a sort)
    keys = _words("uniform", n, dev).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    chosen = shipped_table._sort_backend(None, keys, n, 1, 4, True)
    assert route in (None, chosen)
    before = cs.launch_counts()
    out_k, out_v = glu_tpu_torch.radix_sort(keys, vals)
    after = cs.launch_counts()
    ref_k, ref_v = glu_tpu_torch.radix_sort(keys, vals, backend="torch")
    _assert_same([out_k.view(torch.int32), out_v.view(torch.int32)],
                 [ref_k.view(torch.int32), ref_v.view(torch.int32)])
    launched = tuple(after[k] - before[k] for k in ("digit_histograms", "onesweep_pass", "sort_single_tile"))
    engine = (0, 0, 1) if n <= cs.SINGLE_TILE_MAX else (1, 4, 0)
    assert launched == (engine if chosen == "cuda" else (0, 0, 0))


def _k3_launches() -> int:
    return cs.launch_counts()["sort_single_tile"]


def _assert_same_as_torch(out, keys, vals, **kw) -> None:
    want = glu_tpu_torch.radix_sort(keys, vals, backend="torch", **kw)
    assert out[0].dtype == out[1].dtype == torch.uint32
    _assert_same([o.view(torch.int32) for o in out], [w.view(torch.int32) for w in want])


@pytest.mark.parametrize("num_steps", [0, 3])
@pytest.mark.parametrize("n", [2, 3, 1024, 6144, 6145, 53_000, cs.SINGLE_TILE_MAX])
def test_a_routed_pair_sort_in_k3s_range_launches_one_k3_and_matches_torch(dev, shipped_table, n, num_steps):
    # one K3 launch a call, the same keys and values as backend="torch"
    keys = _words("uniform", n, dev).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    before = cs.launch_counts()
    out = glu_tpu_torch.radix_sort(keys, vals, num_steps)
    after = cs.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"digit_histograms": 0, "onesweep_pass": 0,
                                                        "sort_single_tile": 1}
    _assert_same_as_torch(out, keys, vals, num_steps=num_steps)


@pytest.mark.parametrize("case", ["non-contiguous", "descending", "bits", "past-k3", "torch", "env-torch"])
def test_pair_sorts_of_other_forms_match_torch(dev, shipped_table, monkeypatch, case):
    n = cs.SINGLE_TILE_MAX + 1 if case == "past-k3" else 10_001
    keys = _words("uniform", 2 * n, dev).view(torch.uint32)
    vals = torch.arange(2 * n, dtype=torch.int32, device=dev).view(torch.uint32)
    keys, vals = (keys[::2], vals[::2]) if case == "non-contiguous" else (keys[:n], vals[:n])
    kw = {"descending": {"descending": True}, "bits": {"bits": tuple(range(5, 29))}}.get(case, {})
    if case == "env-torch":
        monkeypatch.setenv("GLU_TPU_TORCH_BACKEND", "torch")
    out = glu_tpu_torch.radix_sort(keys, vals, backend="torch" if case == "torch" else None, **kw)
    _assert_same_as_torch(out, keys, vals, **kw)


def test_a_routed_pair_sort_makes_no_host_sync(dev, shipped_table):
    keys = _words("uniform", 53_000, dev).view(torch.uint32)
    vals = torch.arange(53_000, dtype=torch.int32, device=dev).view(torch.uint32)
    glu_tpu_torch.radix_sort(keys, vals)
    torch.cuda.synchronize()
    before = _k3_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = glu_tpu_torch.radix_sort(keys, vals)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _k3_launches() == before + 1
    _assert_same_as_torch(out, keys, vals)


@pytest.mark.parametrize("n", [1000, cs.SINGLE_TILE_MAX + 1])
def test_sort_streams_refuses_more_streams_than_the_c_entries_take(dev, n):
    keys = _words("uniform", n, dev)
    with pytest.raises(glu_tpu_torch.GluError, match="at most 7 payload streams, got 8"):
        cs.sort_streams(keys, [keys] * cs.MAX_STREAMS, tuple(range(32)))


@pytest.mark.parametrize("n", [1000, 53_000, cs.SINGLE_TILE_MAX + 1])
def test_sort_streams_takes_uint32_words_as_they_are(dev, n):
    # the launch reads the words whatever their dtype; the outputs keep it
    keys, vals = _words("uniform", n, dev), torch.arange(n, dtype=torch.int32, device=dev)
    got_k, got_p = cs.sort_streams(keys.view(torch.uint32), [vals.view(torch.uint32), vals], tuple(range(32)))
    want_k, want_p = cs.sort_streams(keys, [vals, vals], tuple(range(32)))
    assert [t.dtype for t in (got_k, *got_p)] == [torch.uint32, torch.uint32, torch.int32]
    _assert_same([got_k.view(torch.int32), got_p[0].view(torch.int32), got_p[1]], [want_k, *want_p])


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
    sorter.prepare_internal_buffers(n, device=dev, backend="cuda")
    sorter(kbuf, vbuf, n - 7, backend="cuda")
    order = np.argsort(keys[: n - 7], kind="stable")
    np.testing.assert_array_equal(kbuf.get_data(), np.r_[keys[order], keys[n - 7:]])
    np.testing.assert_array_equal(vbuf.get_data(), np.r_[order, vals[n - 7:]])


def _f32_specials(rng, n: int) -> np.ndarray:
    """Normal floats with +-0.0, +-inf and NaNs of both signs sprinkled in."""
    k = rng.standard_normal(n).astype(np.float32)
    specials = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                         0xFFFFFFFF], dtype=np.uint32).view(np.float32)
    k[rng.integers(0, n, n // 50)] = specials[rng.integers(0, specials.size, n // 50)]
    return k


def _variant_inputs(rng, n: int) -> dict:
    u = rng.integers(0, 2**32, n, dtype=np.uint32)
    k64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k64[: n // 8] |= np.uint64(1 << 63)  # keys >= 2**63
    k64[n // 2 :] = k64[: n - n // 2]  # duplicates
    k64[::5] = (k64[0] & np.uint64(0xFFFFFFFF00000000)) | (k64[::5] & np.uint64(0xFFFFFFFF))  # equal hi words
    return {"u": u, "dups": u & np.uint32(0xFFF), "low10": u & np.uint32(0x3FF), "zeros": u & np.uint32(0),
            "f32": _f32_specials(rng, n), "i32": u.view(np.int32), "i32 >> 20": u.view(np.int32) >> 20,
            "k64": k64, "k64 < 2**40": k64 & np.uint64((1 << 40) - 1), "iota": np.arange(n, dtype=np.uint32),
            "u 4 partitions": u[: n // 4 * 4], "iota 4 partitions": np.arange(n // 4 * 4, dtype=np.uint32)}


SORT_VARIANTS = {  # name -> (inputs on the card, backend) -> outputs
    "keys": lambda x, b: glu_tpu_torch.radix_sort_keys(x["u"], backend=b),
    "keys num_steps=3": lambda x, b: glu_tpu_torch.radix_sort_keys(x["u"], 3, backend=b),
    "multi 7 payloads": lambda x, b: glu_tpu_torch.radix_sort_multi(x["dups"], [x["iota"]] + [x["u"]] * 6, backend=b),
    "multi 9 payloads": lambda x, b: glu_tpu_torch.radix_sort_multi(x["dups"], [x["iota"]] + [x["u"]] * 8, backend=b),
    "argsort descending": lambda x, b: glu_tpu_torch.radix_argsort(x["dups"], descending=True, backend=b),
    "descending auto": lambda x, b: glu_tpu_torch.radix_sort(x["low10"], x["iota"], descending=True, bits="auto",
                                                             backend=b),
    "auto below 2**10": lambda x, b: glu_tpu_torch.radix_sort(x["low10"], x["iota"], bits="auto", backend=b),
    "auto constant": lambda x, b: glu_tpu_torch.radix_sort(x["zeros"], x["iota"], bits="auto", backend=b),
    "bits (0, 3, 9, 17, 31)": lambda x, b: glu_tpu_torch.radix_sort(x["u"], x["iota"], bits=(0, 3, 9, 17, 31),
                                                                    backend=b),
    "f32 specials": lambda x, b: glu_tpu_torch.radix_sort_f32(x["f32"], x["iota"], backend=b),
    "f32 specials descending": lambda x, b: glu_tpu_torch.radix_sort_f32(x["f32"], x["iota"], descending=True,
                                                                         backend=b),
    "i32": lambda x, b: glu_tpu_torch.radix_sort_i32(x["i32"], x["iota"], backend=b),
    "i32 descending auto": lambda x, b: glu_tpu_torch.radix_sort_i32(x["i32 >> 20"], x["iota"], descending=True,
                                                                     bits="auto", backend=b),
    "u64": lambda x, b: glu_tpu_torch.radix_sort_u64(x["k64"], x["iota"], backend=b),
    "u64 auto": lambda x, b: glu_tpu_torch.radix_sort_u64(x["k64 < 2**40"], x["iota"], bits="auto",
                                                          backend=b),
    "u64 parts bit pair": lambda x, b: glu_tpu_torch.radix_sort_u64_parts(
        x["dups"], x["u"], x["iota"], bits=(tuple(range(12)), (31, 0, 7)), backend=b),
    "segmented offsets": lambda x, b: glu_tpu_torch.radix_sort_segmented(x["u"], x["iota"], offsets=x["offsets"],
                                                                         backend=b),
    "segmented 4 partitions": lambda x, b: glu_tpu_torch.radix_sort_segmented(x["u 4 partitions"],
                                                                              x["iota 4 partitions"], 4, backend=b),
}


def _bits_of(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _flat(out) -> list:
    return [t for o in (out if isinstance(out, tuple) else (out,)) for t in (o if isinstance(o, tuple) else (o,))]


@pytest.mark.parametrize("n", [10_001, 3 * cs.TILE + 777, 1_000_003])
@pytest.mark.parametrize("variant", list(SORT_VARIANTS))
def test_sort_variant_matches_torch_backend(dev, variant, n):
    # K3 alone, a few tiles with a ragged tail, many tiles: bit for bit
    # against the "torch" backend (one stable torch.sort) on the same keys
    rng = np.random.default_rng(n)
    x = {k: glu_tpu_torch.from_numpy(v, dev) for k, v in _variant_inputs(rng, n).items()}
    x["offsets"] = torch.tensor(np.r_[0, np.sort(rng.integers(0, n + 1, 299)), n], device=dev)
    before = sum(cs.launch_counts().values())
    got = _flat(SORT_VARIANTS[variant](x, "cuda"))
    launched = sum(cs.launch_counts().values()) - before
    want = _flat(SORT_VARIANTS[variant](x, "torch"))
    _assert_same([_bits_of(t) for t in got], [_bits_of(t) for t in want])
    assert launched >= 1 and all(t.is_cuda for t in got)


@pytest.mark.parametrize("mask", [0, 1, 0x3FF, 0x80000001, 0x0F0F00F0, 0xFFFFFFFF])
def test_varying_key_bits_on_card(dev, mask):
    # the envelope by one digit_histograms launch against numpy's OR ^ AND
    rng = np.random.default_rng(mask)
    keys = (rng.integers(0, 2**32, 1_000_003, dtype=np.uint32) & np.uint32(mask)) | np.uint32(0x12345678 & ~mask)
    want = int(np.bitwise_or.reduce(keys) ^ np.bitwise_and.reduce(keys))
    before = cs.launch_counts()
    got = glu_tpu_torch.varying_key_bits(glu_tpu_torch.from_numpy(keys, dev))
    after = cs.launch_counts()
    assert got == tuple(b for b in range(32) if (want >> b) & 1)
    assert {k: after[k] - before[k] for k in after} == {"digit_histograms": 1, "onesweep_pass": 0, "sort_single_tile": 0}


KERNEL_DTYPES = [torch.int32, torch.uint32, torch.float32, torch.float64]
# ragged, one tile, 100 partitions of 1000, the UVEC4 layout (4 partitions),
# the sort's [digit][tile] table (16 x 65536)
FOLD_SHAPES = [(1, 1), (1, 4097), (1, 100_003), (100, 1000), (4, 65_539), (16, 65_536)]


def _fold_input(dtype, op, shape, dev) -> torch.Tensor:
    """Seeded values that keep every prefix meaningful: odd integer factors
    for MUL, factors near 1 for float MUL, positive float addends (no
    cancellation), and a NaN in row 0 for float MIN/MAX."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1] + op.value)
    n = int(np.prod(shape))
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


# K5 also takes (P, L, C): an (N, C) stream read in place, a row of vectors
# ragged against the tile, three rows of 4-vectors
REDUCE_SHAPES = FOLD_SHAPES + [(1, 100_003, 2), (3, 4_097, 4)]


def _reduce_once(x: torch.Tensor, op) -> torch.Tensor:
    """K5 against its plain version, in one launch."""
    before = cr.launch_counts()["reduce"]
    got = cr.reduce_partitions(x, op)
    assert cr.launch_counts()["reduce"] - before == 1
    _assert_close(got, cr.reduce_partitions_ref(x, op))
    return got


@pytest.mark.parametrize("shape", REDUCE_SHAPES)
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("op", list(ReduceOperator))
def test_reduce_partitions_match_plain(dev, op, dtype, shape):
    _reduce_once(_fold_input(dtype, op, shape, dev), op)


@pytest.mark.parametrize("shape", [(1, 100_003, 4), (2, 5_001, 2), (3, 7_001)])
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("op", list(ReduceOperator))
def test_reduce_partitions_unaligned(dev, op, dtype, shape):
    # rows that start off a 16-byte boundary take the kernel's 1-wide loads,
    # for float64 4-vectors too, with each component in its own lanes
    flat = _fold_input(dtype, op, (1, int(np.prod(shape)) + 1), dev)
    x = flat.view(-1)[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    _reduce_once(x, op)


@pytest.mark.parametrize("shape", [(1_100, 5_000), (2_000, 300, 4)])
@pytest.mark.parametrize("dtype", [torch.uint32, torch.float64])
def test_reduce_partitions_one_cta_a_row(dev, dtype, shape):
    # more rows than MAX_CTAS: one CTA a row writes its result itself, with no ticket
    assert cr.ctas_per_partition(shape[0], int(np.prod(shape[1:]))) == 1
    _reduce_once(_fold_input(dtype, ReduceOperator.SUM, shape, dev), ReduceOperator.SUM)


@pytest.mark.parametrize("shape", [(1, 1 << 22), (1, 1 << 20, 4)])
@pytest.mark.parametrize("dtype,op", [(torch.float32, ReduceOperator.SUM), (torch.float64, ReduceOperator.MUL)])
def test_reduce_partitions_same_from_run_to_run(dev, dtype, op, shape):
    # whichever CTA comes last folds the partials in CTA order: the float
    # result must not change
    x = _fold_input(dtype, op, shape, dev)
    first = _reduce_once(x, op)
    for _ in range(4):
        assert torch.equal(cr.reduce_partitions(x, op).view(torch.int8), first.view(torch.int8))


def test_reduce_partitions_leave_tickets_at_zero(dev):
    # 200 reduces of varying rows and components, no sync between them: each
    # is right only if the one before left every ticket at 0
    rng = np.random.default_rng(3)
    cases = []
    for i in range(200):
        comps = (1, 2, 4)[i % 3]
        shape = (int(rng.integers(1, 9)), int(rng.integers(1, 40_000))) + ((comps,) if comps > 1 else ())
        x = torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))
        x = x.to(dev).view(torch.uint32)
        cases.append((x, cr.reduce_partitions(x, ReduceOperator.SUM)))
    for x, got in cases:
        _assert_close(got, cr.reduce_partitions_ref(x, ReduceOperator.SUM))


def test_reduce_partitions_on_a_side_stream(dev):
    # a reduce on a side stream and one on the default stream, unsynchronised
    # with each other: each stream has its own tickets and partials
    side = torch.cuda.Stream(dev)
    x = _fold_input(torch.uint32, ReduceOperator.SUM, (4, 200_003), dev)
    y = _fold_input(torch.float32, ReduceOperator.MAX, (2, 100_001, 4), dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        on_side = [cr.reduce_partitions(x, ReduceOperator.SUM) for _ in range(20)]
    on_default = [cr.reduce_partitions(y, ReduceOperator.MAX) for _ in range(20)]
    torch.cuda.current_stream(dev).wait_stream(side)
    for got in on_side:
        _assert_close(got, cr.reduce_partitions_ref(x, ReduceOperator.SUM))
    for got in on_default:
        _assert_close(got, cr.reduce_partitions_ref(y, ReduceOperator.MAX))


@pytest.mark.parametrize("shape", FOLD_SHAPES)
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("op", list(ReduceOperator))
def test_exclusive_scan_partitions_match_plain(dev, op, dtype, shape):
    x = _fold_input(dtype, op, shape, dev)
    before = csc.launch_counts()["exclusive_scan"]
    got = csc.exclusive_scan_partitions(x, op)
    assert csc.launch_counts()["exclusive_scan"] - before == 1
    _assert_close(got, csc.exclusive_scan_partitions_ref(x, op))


@pytest.mark.parametrize("shape", [(1, 1 << 22), (64, 3 * 4096 + 5)])
@pytest.mark.parametrize("dtype,op", [(torch.float32, ReduceOperator.SUM), (torch.float64, ReduceOperator.MUL)])
def test_exclusive_scan_same_from_run_to_run(dev, dtype, op, shape):
    # which tile a look-back stops at depends on timing; the float result must not
    x = _fold_input(dtype, op, shape, dev)
    first = csc.exclusive_scan_partitions(x, op)
    for _ in range(4):
        assert torch.equal(csc.exclusive_scan_partitions(x, op).view(torch.int8), first.view(torch.int8))


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["nan", "+inf", "-inf", "+inf then -inf"])
def test_scan_sum_non_finite_is_exact(dev, case, dtype, inclusive):
    # fault F1 on the card: "cuda" and "torch" both give the exact scan of a
    # float SUM, against a float64 cumsum (shifted one slot when exclusive),
    # with the non-finite values at the edges of K4's tiles and inside them
    tile = csc.TILE
    places = {"nan": [(tile + 17, np.nan)], "+inf": [(tile, np.inf)], "-inf": [(2 * tile - 1, -np.inf)],
              "+inf then -inf": [(tile - 1, np.inf), (2 * tile + 100, -np.inf)]}[case]
    data = np.random.default_rng(21).uniform(0, 1, 3 * tile + 5)
    for i, v in places:
        data[i] = v
    inc = np.cumsum(data)
    want = torch.from_numpy(inc if inclusive else np.r_[0.0, inc[:-1]])
    x = torch.from_numpy(data).to(dtype).to(dev)
    fn = glu_tpu_torch.inclusive_scan if inclusive else glu_tpu_torch.exclusive_scan
    for backend in ("cuda", "torch"):
        got = fn(x, backend=backend)
        assert got.dtype == dtype
        got = got.double().cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want)), backend
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3, equal_nan=True)


@pytest.mark.parametrize("op", list(ReduceOperator))
def test_reduce_and_scan_entry_points_match_torch(dev, op):
    # the public entry points, "cuda" against "torch", on scalars and on
    # the (N, 4) layout of UVEC4
    for shape in [(1 << 20,), (100_003, 4), (100_003, 2), (100_003, 3)]:
        x = _fold_input(torch.uint32, op, (1, int(np.prod(shape))), dev).reshape(shape)
        _assert_close(glu_tpu_torch.reduce(x, op, backend="cuda"), glu_tpu_torch.reduce(x, op, backend="torch"))
        for fn in (glu_tpu_torch.exclusive_scan, glu_tpu_torch.inclusive_scan):
            _assert_close(fn(x, op=op, backend="cuda"), fn(x, op=op, backend="torch"))
    n = 1 << 20
    x = _fold_input(torch.uint32, op, (1, n), dev).reshape(n)
    cuts = np.sort(np.random.default_rng(op.value).integers(0, n + 1, 999))
    offs = torch.from_numpy(np.concatenate([[0], cuts, [n]])).to(dev)
    _assert_close(glu_tpu_torch.segmented_reduce(x, offs, op, backend="cuda"),
                  glu_tpu_torch.segmented_reduce(x, offs, op, backend="torch"))
    _assert_close(glu_tpu_torch.exclusive_scan(x, op=op, offsets=offs, backend="cuda"),
                  glu_tpu_torch.exclusive_scan(x, op=op, offsets=offs, backend="torch"))


def test_reduce_and_scan_classes_on_default_device(dev):
    # DeviceBuffer(numpy) goes to the card by default; the classes work in place
    data = np.random.default_rng(5).integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    buf = glu_tpu_torch.DeviceBuffer(data)
    assert buf.device.type == "cuda"
    glu_tpu_torch.BlellochScan(glu_tpu_torch.DataType.UINT)(buf, 1 << 15, 2, backend="cuda")
    want = np.concatenate([np.cumsum(p, dtype=np.uint32) - p for p in data.reshape(2, -1)])
    np.testing.assert_array_equal(buf.get_data(), want)
    buf = glu_tpu_torch.DeviceBuffer(data)
    result = glu_tpu_torch.Reduce(glu_tpu_torch.DataType.UINT, ReduceOperator.MAX)(buf, 1000, backend="cuda")
    assert int(result) == int(data[:1000].max()) == int(buf.get_data()[0])
    np.testing.assert_array_equal(buf.get_data()[1:], data[1:])


# ---------------------------------------------------------------------------
# the distributed layer on a 1-rank NCCL group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_group(tmp_path_factory):
    """The default group: NCCL, one rank, on the card; destroyed after the
    module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL serves cuda tensors")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _dist_sort_inputs(form: str, n: int, dev):
    rng = np.random.default_rng(n + len(form))
    vals = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    if form == "f32":
        return (torch.from_numpy(_f32_specials(rng, n)).to(dev), vals)
    if form == "i32":
        return (_words("uniform", n, dev), vals)
    if form in ("u64", "u64 parts"):
        k = torch.from_numpy(rng.integers(0, 2**64, n // 4 + 1, dtype=np.uint64)[rng.integers(0, n // 4 + 1, n)]).to(dev)
        if form == "u64":
            return (k, vals)
        pairs = k.view(torch.int32).view(-1, 2)
        return (pairs[:, 1].contiguous().view(torch.uint32), pairs[:, 0].contiguous().view(torch.uint32), vals)
    keys = _words("mod3" if "bits" in form else "uniform", n, dev).view(torch.uint32)
    return (keys, vals)


_DIST_FORMS = {  # form: (distributed function, single-card function, keywords)
    "u32": ("distributed_radix_sort", "radix_sort", {}),
    "u32 descending, bits auto": ("distributed_radix_sort", "radix_sort", {"descending": True, "bits": "auto"}),
    "f32": ("distributed_radix_sort_f32", "radix_sort_f32", {}),
    "i32": ("distributed_radix_sort_i32", "radix_sort_i32", {}),
    "u64": ("distributed_radix_sort_u64", "radix_sort_u64", {}),
    "u64 parts": ("distributed_radix_sort_u64_parts", "radix_sort_u64_parts", {"bits": "auto"}),
}


@pytest.mark.parametrize("n", [10_001, 1_000_003])
@pytest.mark.parametrize("form", list(_DIST_FORMS))
def test_distributed_sort_one_rank_matches_single_card(dev, nccl_group, form, n):
    # one rank is the exact fast path: the local sort alone, with its launches
    from glu_tpu_torch import parallel

    dist_name, single_name, kw = _DIST_FORMS[form]
    args = _dist_sort_inputs(form, n, dev)
    before = cs.launch_counts()
    got = getattr(parallel, dist_name)(*args, backend="cuda", **kw)
    middle = cs.launch_counts()
    want = getattr(glu_tpu_torch, single_name)(*args, backend="cuda", **kw)
    after = cs.launch_counts()
    assert {k: middle[k] - before[k] for k in after} == {k: after[k] - middle[k] for k in after}
    counts, overflow = got[-2], got[-1]
    assert counts.dtype == overflow.dtype == torch.int32 and counts.is_cuda
    assert counts.tolist() == [n] and overflow.tolist() == [0]
    _assert_same([t.view(torch.uint8) for t in got[:-2]], [t.view(torch.uint8) for t in want])


@pytest.mark.parametrize("op", list(ReduceOperator))
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32, torch.float64])
def test_distributed_primitives_one_rank_match_single_card(dev, nccl_group, dtype, op):
    from glu_tpu_torch import parallel

    x = _fold_input(dtype, op, (1, 1_000_003), dev).reshape(-1)
    if dtype.is_floating_point:
        x = x.abs() if op == ReduceOperator.SUM else x  # no -0.0 prefix, which + 0.0 would make +0.0
        x = torch.nan_to_num(x, nan=0.5)
    pairs = [(parallel.distributed_reduce, glu_tpu_torch.reduce),
             (parallel.distributed_exclusive_scan, glu_tpu_torch.exclusive_scan),
             (parallel.distributed_inclusive_scan, glu_tpu_torch.inclusive_scan)]
    for dist_fn, single_fn in pairs:
        got = dist_fn(x, None, op, backend="cuda")
        want = single_fn(x, op=op, backend="cuda")
        assert got.dtype == want.dtype and got.shape == want.shape and got.is_cuda
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)), dist_fn.__name__


def test_distributed_tensor_must_suit_the_group(dev, nccl_group):
    # NCCL serves cuda tensors, gloo cpu tensors: the other raises before any collective
    import torch.distributed as dist

    from glu_tpu_torch import GluError, parallel

    gloo = dist.new_group(backend="gloo")
    on_card = torch.arange(1000, dtype=torch.int32, device=dev).view(torch.uint32)
    on_host = torch.arange(1000, dtype=torch.int32).view(torch.uint32)
    for keys, group in ((on_card, gloo), (on_host, None), (on_host, nccl_group)):
        with pytest.raises(GluError, match="cannot go through a group"):
            parallel.distributed_radix_sort(keys, keys, group)
        with pytest.raises(GluError, match="cannot go through a group"):
            parallel.distributed_reduce(keys, group)
        with pytest.raises(GluError, match="cannot go through a group"):
            parallel.distributed_exclusive_scan(keys, group)
    dist.destroy_process_group(gloo)


# ---------------------------------------------------------------------------
# KB, the bucket stage of the distributed sort (csrc/bucket.cu)
# ---------------------------------------------------------------------------

_KB_N = 1 << 28  # chip_smoke.py phase 11's global array


def _kb_words(n: int, dev, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen).view(torch.uint32)


def _kb_splitters(words: list, world: int, samples: int = 8192) -> tuple:
    """The splitters the distributed sort makes for a global array cut into
    `world` shards, every rank's samples gathered in rank order."""
    from glu_tpu_torch.parallel import dist_sort as ds

    n = words[0].shape[0] // world
    if len(words) == 1:
        local = [ds._local_samples(words[0][r * n:(r + 1) * n], r, samples) for r in range(world)]
        return ds._sample_splitters(torch.cat([s for s, _ in local]), torch.cat([i for _, i in local]), world)
    local = [ds._local_samples64(words[0][r * n:(r + 1) * n], words[1][r * n:(r + 1) * n], r, samples)
             for r in range(world)]
    return ds._sample_splitters64(*(torch.cat([loc[j] for loc in local]) for j in range(3)), world)


def _kb_check(shard: list, base: int, splitters: tuple) -> None:
    """KB against its plain version, bit for bit, in one launch."""
    from glu_tpu_torch.parallel import _cuda_bucket as cb

    fn, ref = (cb.bucket_of, cb.bucket_of_ref) if len(shard) == 1 else (cb.bucket_of64, cb.bucket_of64_ref)
    before = cb.launch_counts()["bucket_of"]
    got = fn(*shard, base, *splitters)
    assert cb.launch_counts()["bucket_of"] == before + 1
    want = ref(*shard, base, *splitters)
    assert got.dtype == torch.int32 and got.is_cuda and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("kind", ["uniform", "constant"])
def test_bucket_of_matches_plain_at_phase_11_shapes(dev, kind, world):
    keys = _kb_words(_KB_N, dev, world)
    if kind == "constant":
        keys.view(torch.int32).fill_(0x5EADBEEF)  # every bucket decided by the global index
    splitters = _kb_splitters([keys], world)
    n = _KB_N // world
    for r in range(world):
        _kb_check([keys[r * n:(r + 1) * n]], r * n, splitters)


@pytest.mark.parametrize("offsets", [(1, 1), (2, 2), (3, 3), (1, 2), (0, 3)])
@pytest.mark.parametrize("words", [1, 2])
def test_bucket_of_on_a_shard_at_a_4_byte_offset(dev, words, offsets):
    # shards are slices of larger tensors: the keys (and the 64-bit form's two
    # words, apart or at one offset) start off a 16-byte boundary, with a
    # ragged tail
    n = (1 << 24) - 5
    full = [_kb_words(n + 8, dev, 7 + w) for w in range(words)]
    splitters = _kb_splitters([f[:4 * (n // 4)] for f in full], 4)
    _kb_check([f[off:off + n] for f, off in zip(full, offsets)], 3 * n, splitters)


@pytest.mark.parametrize("world", [4, 2050, 4097])
def test_bucket_of64_matches_plain(dev, world):
    # 2^24 64-bit keys with duplicates; D - 1 splitters in shared memory and
    # past SMEM_SPLITTERS (searched in global memory)
    from glu_tpu_torch.parallel import _cuda_bucket as cb

    n = 1 << 24
    gen = torch.Generator(device=dev)
    gen.manual_seed(world)
    hi = _kb_words(n // 8, dev, world).view(torch.int32).repeat(8)[torch.randperm(n, device=dev, generator=gen)]
    hi, lo = hi.view(torch.uint32), _kb_words(n, dev, world + 1)
    splitters = _kb_splitters([hi, lo], world, 8192 if world == 4 else 16)
    assert splitters[0].shape[0] == world - 1 and (world == 4 or world - 1 > cb.SMEM_SPLITTERS)
    q = n // world
    for r in (0, world - 1):
        _kb_check([hi[r * q:(r + 1) * q], lo[r * q:(r + 1) * q]], r * q, splitters)


@pytest.mark.parametrize("world", [2049, 2050])
def test_bucket_of_at_the_shared_memory_limit(dev, world):
    # D - 1 = SMEM_SPLITTERS staged, one more searched in global memory
    from glu_tpu_torch.parallel import _cuda_bucket as cb

    keys = _kb_words(1 << 22, dev, world)
    splitters = _kb_splitters([_kb_words(4096 * world, dev, 3)], world, 16)
    assert splitters[0].shape[0] - cb.SMEM_SPLITTERS == world - 2049
    _kb_check([keys], 1 << 40, splitters)


def test_bucket_of_repeated_splitters(dev):
    # fewer samples than ranks: 3 samples for 8 ranks give 7 splitters with repeats
    from glu_tpu_torch.parallel import dist_sort as ds

    keys = _kb_words(1 << 24, dev, 11)
    few = _kb_words(3, dev, 12)
    splitters = ds._sample_splitters(few, torch.tensor([5, 1 << 20, 3 << 22], dtype=torch.int64, device=dev), 8)
    assert len({(int(k), int(i)) for k, i in zip(splitters[0].view(torch.int32), splitters[1])}) == 3
    _kb_check([keys], 0, splitters)


def test_measure_elapsed_time_without_device_covers_the_device_work(dev):
    # timed without `device`, the host clock stops after the sort's device
    # work: at least 0.9 of the same call's CUDA-event time
    from glu_tpu_torch.utils.timing import measure_elapsed_time

    keys, vals = _kb_words(1 << 26, dev, 1), torch.arange(1 << 26, dtype=torch.int32, device=dev).view(torch.uint32)
    sort = lambda: glu_tpu_torch.radix_sort(keys, vals, backend="cuda")  # noqa: E731
    sort()
    torch.cuda.synchronize()
    host, events = [], []
    for _ in range(5):
        host.append(measure_elapsed_time(sort)[0])
        torch.cuda.synchronize()
        events.append(measure_elapsed_time(sort, dev)[0])
    assert sorted(host)[2] >= 0.9 * sorted(events)[2], (host, events)


# ---------------------------------------------------------------------------
# the port's tracing on the card (utils/timing.py)
# ---------------------------------------------------------------------------


def _sync_inputs(n: int, dev):
    """The calls' inputs, made on the card before anything is counted."""
    from types import SimpleNamespace

    k = _words("uniform", n, dev).view(torch.uint32)
    offs = [0, 10, 10, n // 2, n]
    return SimpleNamespace(n=n, k=k, v=torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32),
                           f=k.view(torch.int32).to(torch.float32), i=k.view(torch.int32),
                           w=_words("uniform", 2 * n, dev).view(torch.uint64), m=n // 4 * 4,
                           offs=offs, card_offs=torch.tensor(offs, device=dev), dev=dev)


_SYNC_CALLS = {  # name: a public call of glu_tpu_torch (g) on the inputs (a)
    "radix_sort": lambda g, a: g.radix_sort(a.k, a.v),
    "radix_sort bits auto": lambda g, a: g.radix_sort(a.k, a.v, bits="auto"),
    "radix_sort descending": lambda g, a: g.radix_sort(a.k, a.v, descending=True),
    "radix_sort_keys bits auto": lambda g, a: g.radix_sort_keys(a.k, bits="auto"),
    "radix_sort_multi 9 payloads": lambda g, a: g.radix_sort_multi(a.k, [a.v] * 9),
    "radix_argsort": lambda g, a: g.radix_argsort(a.k),
    "radix_sort_f32": lambda g, a: g.radix_sort_f32(a.f, a.v),
    "radix_sort_i32": lambda g, a: g.radix_sort_i32(a.i, a.v),
    "radix_sort_u64": lambda g, a: g.radix_sort_u64(a.w, a.v),
    "radix_sort_u64_parts bits auto": lambda g, a: g.radix_sort_u64_parts(a.k, a.v, a.v, bits="auto"),
    "radix_sort_segmented": lambda g, a: g.radix_sort_segmented(a.k[: a.m], a.v[: a.m], 4),
    "radix_sort_segmented host offsets": lambda g, a: g.radix_sort_segmented(a.k, a.v, offsets=a.offs),
    "radix_sort_segmented card offsets": lambda g, a: g.radix_sort_segmented(a.k, a.v, offsets=a.card_offs),
    "varying_key_bits": lambda g, a: g.varying_key_bits(a.k),
    "RadixSort": lambda g, a: g.RadixSort()(a.k, a.v, a.n),
    "RadixSort.prepare_internal_buffers": lambda g, a: g.RadixSort().prepare_internal_buffers(a.n, device=a.dev),
    "exclusive_scan": lambda g, a: g.exclusive_scan(a.k),
    "inclusive_scan f32 max": lambda g, a: g.inclusive_scan(a.f, op=ReduceOperator.MAX),
    "exclusive_scan card offsets": lambda g, a: g.exclusive_scan(a.k, offsets=a.card_offs),
    "exclusive_scan host offsets max": lambda g, a: g.exclusive_scan(a.k, op=ReduceOperator.MAX, offsets=a.offs),
    "BlellochScan": lambda g, a: g.BlellochScan(g.DataType.UINT)(a.k, 1 << 12, 2),
    "reduce": lambda g, a: g.reduce(a.k),
    "reduce f64 max": lambda g, a: g.reduce(a.f.to(torch.float64), ReduceOperator.MAX),
    "segmented_reduce host offsets": lambda g, a: g.segmented_reduce(a.k, a.offs),
    "segmented_reduce card offsets min": lambda g, a: g.segmented_reduce(a.k, a.card_offs, ReduceOperator.MIN),
    "Reduce": lambda g, a: g.Reduce(g.DataType.UINT, ReduceOperator.SUM)(a.k, a.n),
}


SYNC_WARNING = "called a synchronizing CUDA operation"  # the sync debug mode's words for each one


def _syncs_and_warnings(call) -> tuple:
    """(the host_syncs counters' gain, the synchronizing operations that
    torch's sync debug mode warns of plus the explicit
    torch.cuda.synchronize calls, which it does not, their messages) over
    one call, after a warm call."""
    import warnings

    from glu_tpu_torch.utils import timing

    call()
    torch.cuda.synchronize()
    before = timing.summary()["counters"]
    synchronize, explicit = torch.cuda.synchronize, []

    def counted_synchronize(*args, **kwargs):
        explicit.append("torch.cuda.synchronize")
        return synchronize(*args, **kwargs)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize = counted_synchronize
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize = synchronize
    after = timing.summary()["counters"]
    counted = sum(v - before.get(k, 0) for k, v in after.items() if k.startswith("host_syncs."))
    flagged = [str(w.message) for w in caught if SYNC_WARNING in str(w.message)] + explicit
    return counted, len(flagged), flagged


@pytest.mark.parametrize("n", [10_001, 1_000_003])
@pytest.mark.parametrize("name", list(_SYNC_CALLS))
def test_host_syncs_count_what_the_sync_debug_mode_flags(dev, shipped_table, name, n):
    # every public function: its host_syncs counters gain what
    # torch.cuda.set_sync_debug_mode flags in the same call
    a = _sync_inputs(n, dev)
    counted, flagged, what = _syncs_and_warnings(lambda: _SYNC_CALLS[name](glu_tpu_torch, a))
    assert counted == flagged, (name, counted, what)


@pytest.mark.parametrize("form, inputs, kw", [
    ("distributed_radix_sort", "u32", {}),
    ("distributed_radix_sort", "u32", {"bits": "auto"}),
    ("distributed_radix_sort_f32", "f32", {}),
    ("distributed_radix_sort_u64", "u64", {}),
    ("distributed_radix_sort_u64_parts", "u64 parts", {"bits": "auto"}),
    ("distributed_reduce", "u32", {}),
    ("distributed_exclusive_scan", "u32", {}),
    ("distributed_inclusive_scan", "u32", {}),
])
def test_host_syncs_of_the_distributed_functions_on_one_rank(dev, nccl_group, form, inputs, kw):
    from glu_tpu_torch import parallel

    args = _dist_sort_inputs(inputs, 100_003, dev)
    if not form.startswith("distributed_radix_sort"):
        args = args[:1]
    counted, flagged, what = _syncs_and_warnings(lambda: getattr(parallel, form)(*args, **kw))
    assert counted == flagged, (form, kw, counted, what)


def test_trace_nests_the_programs_spans_in_the_callers_on_the_device_timeline(dev, tmp_path):
    import json

    from glu_tpu_torch.utils import timing

    keys = _words("uniform", 50_000, dev).view(torch.uint32)
    glu_tpu_torch.radix_sort(keys, keys)
    torch.cuda.synchronize()
    with timing.trace(str(tmp_path)):
        with torch.profiler.record_function("caller"):
            glu_tpu_torch.radix_sort(keys, keys)
        torch.cuda.synchronize()
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = {e["name"]: e for e in events if e["name"].startswith("glu.")}
    assert set(spans) == {"glu.radix_sort", "glu.route", "glu.engine.k3", "glu.launch"}

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    caller = next(e for e in events if e["name"] == "caller" and e["cat"] == "user_annotation")
    assert inside(spans["glu.radix_sort"], caller)
    for name in ("glu.route", "glu.engine.k3"):
        assert inside(spans[name], spans["glu.radix_sort"]), name
    assert inside(spans["glu.launch"], spans["glu.engine.k3"])
    # the kernel launched inside glu.launch runs after it on the same timeline
    runtime = [e for e in events if e.get("cat") == "cuda_runtime" and inside(e, spans["glu.launch"])]
    kernels = [e for e in events if e.get("cat") == "kernel" and "sort_single_tile" in e["name"]]
    assert runtime and len(kernels) == 1 and kernels[0]["ts"] >= spans["glu.launch"]["ts"]
    gained = json.loads((tmp_path / "summary.json").read_text())
    assert gained["spans"]["glu.launch"]["count"] == 1 and gained["counters"]["launches.sort_single_tile"] == 1
