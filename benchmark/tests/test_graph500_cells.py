"""The cells this file's two traffic mixes add, rehearsed on the CPU at
sizes of their own (the port's plain versions): Graph 500's kernel 1
(graph500_kron_1card.csr_build) and CUB's entropy-0.201 keys
(u32_2p28_1card.sort_entropy0201). A sound run is correct; the control and
each fault planted under the timed path are not. The Graph 500 reference
against the port's golden ref_csr, cut into pieces or not; its readers'
arithmetic on hand-made runs, and nothing, without raising, from a program
that does not count the two-word chain. On a card (marker `cuda`), both
cells through benchmark/run.py for a second, one after the other."""

import json
import subprocess
import sys
import time

import pytest
import torch

import glu_tpu_torch as glu
from benchmark import devtrace, harness, roofline, workload
from benchmark.reference import graph500
from glu_tpu_torch.ops.reference import ref_csr

GRAPH500, ENTROPY = "graph500_kron_1card.csr_build", "u32_2p28_1card.sort_entropy0201"
OVERRIDES = {GRAPH500: {"config": {"n": 16 << 10}}, ENTROPY: {"config": {"n": 1 << 16}}}


def run(name: str, trace: bool = False, patch: str | None = None) -> dict:
    """A run of 0.3 s; traced, of 1 s, so that the traced steps start (a third of the way in) on a loaded host."""
    return harness.run_cell(name, 2**31 + 13, 1.0 if trace else 0.3, trace, t_start=time.time(), device_type="cpu",
                            overrides=OVERRIDES[name], patch=patch)


def drop_low_dst_bits():
    """The two-word sort by all of src's id bits and dst's from bit 8 up."""
    original = glu.radix_sort_u64_parts

    def broken(hi, lo, values, *, bits, **kw):
        return original(hi, lo, values, bits=(bits[0], tuple(bits[1])[8:]), **kw)

    glu.radix_sort_u64_parts = broken
    return lambda: setattr(glu, "radix_sort_u64_parts", original)


def shift_offsets():
    """Each row starting where the next one does."""
    original = glu.exclusive_scan
    glu.exclusive_scan = lambda x, *a, **kw: torch.roll(original(x, *a, **kw), -1)
    return lambda: setattr(glu, "exclusive_scan", original)


@pytest.mark.parametrize("cell", [GRAPH500, ENTROPY])
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(c["value"] == 0 for k, c in result["checks"].items() if k != "answers_checked")
    assert set(result["metrics"]) == {"sort_pairs_per_s", "setup_s"}


@pytest.mark.parametrize("cell, patch", [
    (GRAPH500, "benchmark.control:use_control"),
    (GRAPH500, f"{__name__}:drop_low_dst_bits"),
    (GRAPH500, f"{__name__}:shift_offsets"),
    (ENTROPY, "benchmark.control:use_control"),
])
def test_control_and_faults_are_not_correct(cell, patch):
    result = run(cell, patch=patch)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["answers_checked"]["value"] > 0


def test_traced_graph500_rehearsal_reads_the_programs_counters():
    from glu_tpu_torch.utils import timing

    timing.reset()  # the counters of this process's earlier runs
    result = run(GRAPH500, trace=True)
    assert result["correct"] is True, result["checks"]
    got = {m: v["value"] for m, v in result["metrics"].items()}
    # scale 10: 8 + 2 bits a word, 2 passes each; a CPU tensor is never routed ("cuda", the plain versions)
    assert got == {"csr.passes_per_build": 4.0, "csr.engine_route_pct": 100.0}  # no device operation on the CPU


@pytest.mark.parametrize("parts", [1, 3, 4, None])
def test_the_reference_equals_ref_csr_whatever_its_pieces(parts):
    cpu = torch.device("cpu")
    traffic = harness.resolve(harness.load_manifest(), GRAPH500)[2]
    n = 16 << 12
    gen = workload.generator(cpu, 77)
    edges = workload.make(traffic["edges"], n, gen, cpu)
    weights = torch.rand(n, generator=gen).view(torch.uint32)
    got = graph500.csr(edges[0], edges[1], weights, n // 16, parts=parts)
    for g, w in zip(got, ref_csr(edges[0], edges[1], weights, n // 16)):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32), w.view(torch.int32))
    control = graph500.csr(edges[0], edges[1], weights, n // 16, by_dst=False, parts=parts)
    assert torch.equal(control[0], got[0]) and not torch.equal(control[1].view(torch.int32), got[1].view(torch.int32))


def _run(work_per_step: int, trace=None) -> harness.Run:
    traffic = {"edges": {"edgefactor": 16}}
    return harness.Run({}, traffic, traces=[trace] if trace else [], work_per_step=work_per_step)


def test_graph500_device_readers_on_a_hand_made_trace():
    ops = [("onesweep_pass_kernel", "kernel", 0.0, 600.0), ("digit_histograms_kernel", "kernel", 600.0, 100.0),
           ("at::native::bincount_kernel", "kernel", 700.0, 200.0), ("Memset (Device)", "gpu_memset", 900.0, 100.0)]
    trace = devtrace.TraceData(2000.0, ops, calls_us=[900.0, 900.0])
    run = _run(1 << 30, trace)
    per_build_s = 1000e-6 / 2
    want = 100 * (20 * 2**30 + 4 * 2**26) / roofline.HBM_BYTES_PER_S / per_build_s
    assert harness.reader("csr.kernels_roofline").read(run) == pytest.approx(want)
    assert harness.reader("csr.sort_share_pct").read(run) == pytest.approx(70.0)
    empty = _run(1 << 30, devtrace.TraceData(2000.0, [], calls_us=[900.0]))
    for metric in ("csr.kernels_roofline", "csr.sort_share_pct", "csr.program_idle_pct"):
        assert harness.reader(metric).read(empty) is None, metric


@pytest.fixture
def counters(monkeypatch):
    """Sets the counters that the program's summary() lists."""
    from glu_tpu_torch.utils import timing

    listed = {}
    original = timing.summary
    monkeypatch.setattr(timing, "summary", lambda: {**original(), "counters": listed})
    return listed


def test_graph500_counter_readers(counters):
    passes, route = harness.reader("csr.passes_per_build"), harness.reader("csr.engine_route_pct")
    assert passes.read(_run(1)) is None and route.read(_run(1)) is None  # a program that lists neither
    counters.update({"sort.two_word": 0, "sort.two_word_passes": 0, "route.u64.cuda": 3})
    assert passes.read(_run(1)) is None and route.read(_run(1)) == 100.0  # no chain on the engine yet
    counters.update({"sort.two_word": 3, "sort.two_word_passes": 24, "route.u64.torch": 1})
    assert passes.read(_run(1)) == 8.0 and route.read(_run(1)) == 75.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the port's CUDA kernels")


@pytest.mark.cuda
def test_cells_on_the_card(card):
    """One cell after the other: the Graph 500 cell holds most of the card's
    memory, so no other run may share the card with it (run the card tests
    in one process: -o addopts="")."""
    for cell in (GRAPH500, ENTROPY):
        out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", cell, "--seed",
                              "4294967302", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                             timeout=600, cwd=harness.ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True and result["device"]["platform"] == "gpu", cell
        assert list(result)[-1] == "checks"
