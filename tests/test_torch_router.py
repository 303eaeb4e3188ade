"""The port's router (glu_tpu_torch/ops/router.py), case by case after
tests/test_router.py: a pure function of (n, payloads, passes, whether the
bits are the whole key) and of the device's cost model, behind the gate
ops/backend.py::routable. On the CPU nothing is routed, so these tests
monkeypatch `routable` to let CPU tensors through (as tests/test_router.py
monkeypatches `is_tpu_backend`) and point GLU_TPU_TORCH_ROUTER_CALIBRATION
at a fixture model in the H100 form with round numbers, so that each
crossover sits where the case says. The shipped table's own crossovers,
measured on an H100, are pinned separately.

The routed end-to-end cases force each route with a model and hold the
port's result bit for bit against glu_tpu's backend="xla" on the same seeded
numpy inputs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glu_tpu
import glu_tpu_torch
from glu_tpu_torch import from_numpy, to_numpy
from glu_tpu_torch.ops import _cuda_reduce as cr
from glu_tpu_torch.ops import _cuda_sort as cs
from glu_tpu_torch.ops import backend as be
from glu_tpu_torch.ops import router
from glu_tpu_torch.utils.errors import GluArgumentError

ENV_MODEL = "GLU_TPU_TORCH_ROUTER_CALIBRATION"
ENV_BACKEND = "GLU_TPU_TORCH_BACKEND"

# A model in the H100 form: K3 costs 30 us + 0.5 ns a key a pass on one CTA,
# 40 us + 0.125 ns on a cluster; the multi-tile path max(130 + 45 a pass us,
# the card's n x rates); torch.sort from 60 ns/key at 2^10 down to 0.1 at
# 2^22.
FIXTURE = {
    "device": "fixture",
    "power_limit_w": None,
    "k3_fixed_us": 30.0,
    "k3_ns_per_key_pass": [0.4, 0.5, 0.6],
    "k3_cluster_fixed_us": 40.0,
    "k3_cluster_ns_per_key_pass": [0.1, 0.125, 0.15],
    "onesweep_fixed_us": 130.0,
    "onesweep_pass_us": 45.0,
    "onesweep_hist_ns_per_key": 0.002,
    "onesweep_ns_per_key_pass": [0.008, 0.0093, 0.015],
    "torch_ns_per_key": {
        "keys": [[10, 50.0], [14, 5.0], [16, 1.6], [20, 0.14], [22, 0.09], [28, 0.09]],
        "kv": [[10, 60.0], [14, 5.5], [16, 1.8], [20, 0.16], [22, 0.1], [28, 0.125]],
        "multi2": [[10, 75.0], [14, 7.0], [16, 2.0], [20, 0.18], [22, 0.11], [28, 0.16]],
        "u64": [[10, 120.0], [14, 13.0], [16, 3.8], [20, 0.31], [22, 0.22], [26, 0.26]],
        "segmented": [[10, 130.0], [14, 14.0], [16, 3.3], [20, 0.32], [22, 0.21], [26, 0.19]],
    },
    "torch_slope": {"keys": 0.0, "kv": 0.001, "multi2": 0.002, "u64": 0.01, "segmented": 0.001},
    "compact_us": 18.0,
    "compact_ns_per_key": 0.0025,
    "reduce_torch_max_n": 0,
}


def _write(path, model: dict) -> str:
    path.write_text(json.dumps(model))
    return str(path)


@pytest.fixture
def on_card(monkeypatch, tmp_path):
    """Route CPU tensors, under FIXTURE, with no override; returns a setter
    that swaps in another model."""
    monkeypatch.setattr(be, "routable", lambda backend, t: backend is None and not os.environ.get(ENV_BACKEND))
    monkeypatch.delenv(ENV_BACKEND, raising=False)

    def use(model: dict) -> None:
        monkeypatch.setenv(ENV_MODEL, _write(tmp_path / f"model{len(list(tmp_path.iterdir()))}.json", model))
        router._reset_router_model()

    use(FIXTURE)
    yield use
    router._reset_router_model()


@pytest.fixture
def shipped(monkeypatch, tmp_path):
    monkeypatch.setattr(be, "routable", lambda backend, t: backend is None and not os.environ.get(ENV_BACKEND))
    monkeypatch.delenv(ENV_BACKEND, raising=False)
    monkeypatch.setenv(ENV_MODEL, str(tmp_path / "absent.json"))
    router._reset_router_model()
    yield
    router._reset_router_model()


T = torch.zeros(1, dtype=torch.int32)  # the routers read the device of the tensor, not its size


@pytest.mark.parametrize("n,want", [
    (2**10, "cuda"), (2**14, "cuda"), (24_577, "cuda"), (2**16, "cuda"), (65_537, "torch"), (2**20, "torch"),
    (2**22, "cuda"), (2**24, "cuda"), (2**28, "cuda"), (2**29, "cuda"),
])
def test_full_width_kv_crossover(on_card, n, want):
    # K3's sizes (one CTA, then a cluster) and the largest go to the engine;
    # from 65,537 pairs its host steps lose to torch.sort until the card's
    # work outweighs them
    assert router._sort_backend(None, T, n, 1, 4) == want


@pytest.mark.parametrize("payloads,n,want", [
    (0, 2**17, "torch"), (0, 2**24, "cuda"), (0, 2**28, "cuda"),
    (2, 2**17, "torch"), (2, 2**22, "cuda"), (2, 2**28, "cuda"),
    # past 7 payloads both backends sort an index: routed as one payload
    (9, 2**17, "torch"), (9, 2**24, "cuda"),
])
def test_keys_only_and_multi_payload(on_card, payloads, n, want):
    assert router._sort_backend(None, T, n, payloads, 4) == want


def test_pruned_bits_favor_engine(on_card):
    # torch.sort cannot exploit lost entropy and masks the key first; one
    # pass costs the engine a quarter of the card's work
    assert router._sort_backend(None, T, 2**20, 1, 4, True) == "torch"
    assert router._sort_backend(None, T, 2**20, 1, 1, False) == "cuda"
    assert router._sort_backend(None, T, 2**28, 1, 2, False) == "cuda"
    # tiny inputs still take the faster call
    assert router._sort_backend(None, T, 2**10, 1, 1, False) == "cuda"
    # no bit to sort: the engine returns at once
    assert router._sort_backend(None, T, 2**20, 1, 0, False) == "cuda"


@pytest.mark.parametrize("n,want", [(cs.SINGLE_TILE_MAX, "cuda"), (cs.SINGLE_TILE_MAX + 1, "torch")])
def test_k3_regime_edge(on_card, n, want):
    # up to 65,536 pairs K3 alone (a cluster: 40 us + its passes), one more
    # pair takes the histogram and 4 onesweep passes (310 us of host steps)
    assert router._sort_backend(None, T, n, 1, 4) == want


@pytest.mark.parametrize("device", [torch.device("cpu"), torch.device("cuda", 0)])
def test_model_read_once_as_measured(on_card, monkeypatch, device):
    # a device's model is read once, where it is first routed, and kept,
    # with the file's times as they were measured
    reads = []
    load = router._load_model
    monkeypatch.setattr(router, "_load_model", lambda d: reads.append(d) or load(d))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "fixture")
    for _ in range(3):
        m = router._cost_model(device)
    assert len(reads) == 1 and device.index in router._models
    assert (m.k3_fixed_us, m.os_fixed_us, m.os_pass_us) == (30.0, 130.0, 45.0)
    assert router._torch_sort_est_s(m, 2**22, 1) == pytest.approx(0.1 * 2**22 * 1e-9)


def test_explicit_choice_and_env_win(on_card, monkeypatch):
    assert router._sort_backend("cuda", T, 2**16, 1, 4) == "cuda"
    assert router._sort_backend("torch", T, 2**28, 1, 4) == "torch"
    assert router._u64_backend("cuda", T, 2**16, 4, 4, 0) == "cuda"
    assert router._segmented_backend("torch", T, 2**28, 4, 2) == "torch"
    monkeypatch.setenv(ENV_BACKEND, "cuda")
    assert router._sort_backend(None, T, 2**16, 1, 4) == "cuda"
    monkeypatch.setenv(ENV_BACKEND, "torch")
    assert router._sort_backend(None, T, 2**28, 1, 4) == "torch"
    assert router._reduce_backend(None, T) == "torch"
    # the override reaches the scans, which have no router
    x = torch.arange(10, dtype=torch.int32)
    assert be.resolve_backend(None, x) == "torch"


@pytest.mark.parametrize("explicit,env", [("bogus", None), (None, "bogus"), (None, "pallas"), ("xla", None)])
def test_bad_backend_raises(on_card, monkeypatch, explicit, env):
    if env is not None:
        monkeypatch.setenv(ENV_BACKEND, env)
    with pytest.raises(GluArgumentError):
        router._sort_backend(explicit, T, 2**20, 1, 4)
    with pytest.raises(GluArgumentError):
        router._reduce_backend(explicit, T)
    with pytest.raises(GluArgumentError):
        glu_tpu_torch.radix_sort(torch.zeros(4, dtype=torch.int32).view(torch.uint32),
                                 torch.zeros(4, dtype=torch.int32).view(torch.uint32), backend=explicit)


def test_cpu_tensor_is_not_routed(monkeypatch, tmp_path):
    # the real gate: a CPU tensor keeps "cuda" (the plain versions) where the
    # model would take torch
    monkeypatch.delenv(ENV_BACKEND, raising=False)
    monkeypatch.setenv(ENV_MODEL, _write(tmp_path / "m.json", FIXTURE))
    router._reset_router_model()
    try:
        assert not be.routable(None, T)
        assert router._sort_backend(None, T, 2**16, 1, 4) == "cuda"
        assert router._u64_backend(None, T, 2**16, 4, 4, 0) == "cuda"
        assert router._segmented_backend(None, T, 2**16, 4, 2) == "cuda"
        assert router._reduce_backend(None, torch.zeros(8)) == "cuda"
        assert not router._models  # no model was read
    finally:
        router._reset_router_model()


@pytest.mark.parametrize("n,p_hi,p_lo,extra,want", [
    # 2^16: two sorts on K3's cluster
    (2**16, 4, 4, 0, "cuda"), (2**20, 4, 4, 0, "torch"), (2**24, 4, 4, 0, "cuda"),
    # keys below 2^40: one pass of the high word
    (2**22, 1, 4, 1, "cuda"),
    (2**12, 4, 4, 0, "cuda"),
])
def test_u64_routes(on_card, n, p_hi, p_lo, extra, want):
    assert router._u64_backend(None, T, n, p_hi, p_lo, extra) == want


@pytest.mark.parametrize("n,key_passes,seg_passes,want", [
    (2**16, 4, 2, "cuda"), (2**18, 4, 2, "torch"), (2**24, 4, 2, "cuda"), (2**12, 4, 2, "cuda"),
    # torch.sort's route 16% faster than the chained engine sorts: within
    # TORCH_MARGIN, a tie, which goes to the engine
    (2**20, 4, 2, "cuda"),
])
def test_segmented_routes(on_card, n, key_passes, seg_passes, want):
    assert router._segmented_backend(None, T, n, key_passes, seg_passes) == want


@pytest.mark.parametrize("max_n,n,want", [
    (0, 1, "cuda"), (0, 2**12, "cuda"),
    (2**12, 2**12, "torch"), (2**12, 2**12 + 1, "cuda"), (2**12, 1, "torch"),
])
def test_reduce_backend(on_card, max_n, n, want):
    # 0: K5 never lost by more than its spread, the router is the constant "cuda"
    on_card(dict(FIXTURE, reduce_torch_max_n=max_n))
    assert router._reduce_backend(None, torch.zeros(n, dtype=torch.int32)) == want
    assert router._reduce_backend("cuda", torch.zeros(n, dtype=torch.int32)) == "cuda"


def test_router_calibration_file(shipped, monkeypatch, tmp_path):
    # a file where the engine's fixed time is catastrophically long flips the
    # 2^20 pair sort (the engine on the shipped table) to torch.sort
    cpu = torch.device("cpu")
    assert router._sort_backend(None, T, 2**20, 1, 4) == "cuda"
    slow = dict(FIXTURE, device="vTEST", onesweep_fixed_us=1e9)
    p = tmp_path / "router.json"
    monkeypatch.setenv(ENV_MODEL, _write(p, slow))
    router._reset_router_model()
    assert router.router_calibration_path() == str(p)
    assert router._router_model(cpu)["device"] == "vTEST"
    assert router._sort_backend(None, T, 2**20, 1, 4) == "torch"
    # unreadable: the shipped table
    p.write_text("{nope")
    router._reset_router_model()
    assert router._router_model(cpu)["device"] == router._H100_MODEL["device"]
    assert router._sort_backend(None, T, 2**20, 1, 4) == "cuda"
    # absent: the same
    monkeypatch.setenv(ENV_MODEL, str(tmp_path / "absent.json"))
    router._reset_router_model()
    assert router._sort_backend(None, T, 2**28, 1, 4) == "cuda"


def test_router_calibration_default_path(monkeypatch, tmp_path):
    monkeypatch.delenv(ENV_MODEL, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert router.router_calibration_path() == str(tmp_path / "glu_tpu_torch" / "router.json")


def test_router_model_cached_and_reset(shipped, monkeypatch, tmp_path):
    cpu = torch.device("cpu")
    m1 = router._router_model(cpu)
    assert router._router_model(cpu) is m1  # read once per device
    monkeypatch.setenv(ENV_MODEL, _write(tmp_path / "m.json", FIXTURE))
    assert router._router_model(cpu) is m1  # the cache holds until reset
    router._reset_router_model()
    assert router._router_model(cpu)["device"] == "fixture"


# The calibration points whose function a fake timer has run in this
# process. Their readings are made up, so a point's function (a sort or a
# reduce on the CPU plain versions) is run once, the first time any timer
# meets the point, to show that calibrate() builds calls that run; running
# it again at every reading and in every case only spent the suite's time.
_RAN_POINTS: set = set()


def _run_once(point, fn) -> None:
    if point not in _RAN_POINTS:
        fn()
        _RAN_POINTS.add(point)


def _fake_timer(seconds):
    """A timer that runs each point's call once and returns
    seconds(*point) of each."""
    def timer(calls):
        for point, fn in calls.items():
            _run_once(point, fn)
        return {point: seconds(*point) for point in calls}
    return timer


def _card_like(backend, form, n, passes):
    """Timings of a slow card: the engine's host steps cost 200 us + 25 a
    pass, its card n x (2 + passes x (8 + 3 a payload)) ns, K3 25 us + 0.5
    ns a key a pass; torch.sort 60 us + 60 ns a key, its masking of the key
    10 us + 0.001 ns a key; reduce: torch wins up to 4,096."""
    if form == "reduce":
        return (10e-6 if n <= 4096 else 30e-6) if backend == "torch" else 20e-6
    if form == "compact":
        return 10e-6 + n * 1e-12
    streams = {"keys": 0, "kv": 1, "multi2": 2, "u64": 2, "segmented": 2}[form]
    if backend == "torch":  # and the masking of the key for 1 pass
        masking = 10e-6 + n * 1e-12 if passes == 1 else 0.0
        return (2.0 if form in ("u64", "segmented") else 1.0) * (60e-6 + n * (60 + 2 * streams) * 1e-9) + masking
    if passes is None:  # the chained two-word sorts
        return 2 * _card_like("cuda", "multi2", n, 4)
    if n <= cs.SINGLE_TILE_MAX:
        return 25e-6 + n * passes * 0.5e-9
    return max(200e-6 + passes * 25e-6, n * (2 + passes * (8 + 3 * streams)) * 1e-9)


def test_calibrate_writes_a_model_that_routes_as_measured(on_card, monkeypatch, tmp_path):
    # calibrate() on CPU tensors (the kernels' plain versions) with a fake
    # timer; the file it writes is what _router_model loads
    monkeypatch.setattr(cs, "TILE", 256)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", 512)
    out = tmp_path / "cal" / "router.json"
    lines = []
    model = router.calibrate("cpu", [64, 256, 512, 513, 1024, 4096, 65536], _fake_timer(_card_like),
                             out=str(out), echo=lines.append)
    assert json.loads(out.read_text()) == model
    assert model["device"] == "cpu" and model["power_limit_w"] is None
    assert model["k3_fixed_us"] == pytest.approx(25.0) and model["k3_ns_per_key_pass"] == pytest.approx([0.5] * 3)
    assert model["onesweep_fixed_us"] == pytest.approx(200.0) and model["onesweep_pass_us"] == pytest.approx(25.0)
    assert model["onesweep_hist_ns_per_key"] == pytest.approx(2.0)
    assert model["onesweep_ns_per_key_pass"] == pytest.approx([8.0, 11.0, 14.0])
    assert model["compact_us"] == pytest.approx(10.0) and model["compact_ns_per_key"] == pytest.approx(0.001)
    assert model["reduce_torch_max_n"] == 4096
    assert sorted(model["torch_ns_per_key"]) == sorted(router.TORCH_FORMS)
    assert [lg for lg, _ in model["torch_ns_per_key"]["kv"]] == pytest.approx([6, 8, 9, 9.002815, 10, 12, 16])
    assert any(line.startswith("calibrate model kv n=4096") for line in lines)
    monkeypatch.setenv(ENV_MODEL, str(out))
    router._reset_router_model()
    assert router._router_model(torch.device("cpu")) == {**router._H100_MODEL, **model}
    # the model routes as its timings say, at sizes it never measured, away
    # from its ties (torch within TORCH_MARGIN of the engine)
    for n in (200, 700, 1500, 2**21, 2**26):
        for streams, form in ((0, "keys"), (1, "kv"), (2, "multi2")):
            torch_t, cuda_t = _card_like("torch", form, n, None), _card_like("cuda", form, n, 4)
            faster = "torch" if torch_t * (1 + router.TORCH_MARGIN) < cuda_t else "cuda"
            assert router._sort_backend(None, T, n, streams, 4) == faster, (n, form)
    assert router._reduce_backend(None, torch.zeros(4096)) == "torch"
    assert router._reduce_backend(None, torch.zeros(4097)) == "cuda"


def _reduce_timer(readings):
    """A timer whose reduce readings are readings[n][backend][i] at its
    i-th timing of size n, the sorts _card_like's."""
    seen = {}

    def timer(calls):
        out = {}
        for point, fn in calls.items():
            _run_once(point, fn)
            backend, form, n, _ = point
            if form != "reduce":
                out[point] = _card_like(*point)
                continue
            i = seen[point] = seen.get(point, -1) + 1
            out[point] = readings[n][backend][i] * 1e-6
        return out
    return timer


STEADY_WIN = {"cuda": [20, 20, 20, 20, 20], "torch": [10, 10, 10, 10, 10]}
STEADY_LOSS = {"cuda": [20, 20, 20, 20, 20], "torch": [25, 25, 25, 25, 25]}
# the host twice as slow in some readings: torch the faster in each
DRIFTING_WIN = {"cuda": [20, 40, 22, 44, 21], "torch": [15, 30, 16, 33, 15]}
# torch the faster by its median, K5 in one reading: no win
MIXED = {"cuda": [20, 20, 20, 20, 20], "torch": [15, 15, 15, 21, 15]}


@pytest.mark.parametrize("readings,want", [
    ({512: STEADY_WIN, 4096: STEADY_WIN, 65536: STEADY_WIN}, 65536),
    ({512: STEADY_WIN, 4096: STEADY_WIN, 65536: STEADY_LOSS}, 4096),
    # a win past a size at which torch did not win does not count
    ({512: STEADY_WIN, 4096: STEADY_LOSS, 65536: STEADY_WIN}, 512),
    ({512: STEADY_LOSS, 4096: STEADY_WIN, 65536: STEADY_WIN}, 0),
    ({512: STEADY_WIN, 4096: MIXED, 65536: STEADY_WIN}, 512),
    ({512: STEADY_WIN, 4096: DRIFTING_WIN, 65536: STEADY_WIN}, 65536),
])
def test_calibrate_reduce_threshold(on_card, monkeypatch, tmp_path, readings, want):
    # torch takes the reduces up to the first size at which it is not the
    # faster in every reading (each reading times the two together)
    monkeypatch.setattr(cs, "TILE", 256)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", 512)
    lines = []
    model = router.calibrate("cpu", list(readings), _reduce_timer(readings), out=str(tmp_path / "r.json"),
                             echo=lines.append)
    assert model["reduce_torch_max_n"] == want
    assert sum(line.startswith("calibrate reduce n=") for line in lines) == len(readings)


def test_calibrate_needs_the_card_or_a_timer():
    with pytest.raises(GluArgumentError):
        router.calibrate("cpu", [64, 1 << 15, 1 << 16])


def _inverted(model: dict) -> dict:
    """The crossover inverted, as chip_smoke.py's guard builds it."""
    return dict(model, k3_fixed_us=model["k3_fixed_us"] / 100, onesweep_fixed_us=model["onesweep_fixed_us"] / 100,
                onesweep_pass_us=model["onesweep_pass_us"] / 100,
                k3_ns_per_key_pass=[r * 100 for r in model["k3_ns_per_key_pass"]],
                onesweep_hist_ns_per_key=model["onesweep_hist_ns_per_key"] * 100,
                onesweep_ns_per_key_pass=[r * 100 for r in model["onesweep_ns_per_key_pass"]])


def test_guard_flags_an_inverted_model(on_card):
    # fake timings that are the fixture's own estimates: the fixture passes
    # the guard everywhere, its inversion fails it at the large sorts
    m = router._CostModel(FIXTURE)
    sizes = (1024, 16384, 24577, 49152, 65536, 2**18, 2**20, 2**22, 2**24, 2**28)
    times = {n: (router._cuda_sort_est_s(m, n, 1, 4) * 1e3, router._torch_sort_est_s(m, n, 1) * 1e3) for n in sizes}

    def flagged() -> list:
        out = []
        for n, (c_ms, t_ms) in times.items():
            routed = c_ms if router._sort_backend(None, T, n, 1, 4) == "cuda" else t_ms
            if not router.within_guard(routed, c_ms, t_ms):
                out.append(n)
        return out

    assert flagged() == []
    on_card(_inverted(FIXTURE))
    assert 2**28 in flagged()
    assert router.within_guard(1.10, 1.0, 2.0) and router.within_guard(0.0199, 2.0, 0.009)
    assert not router.within_guard(1.111, 1.0, 2.0) and not router.within_guard(0.0201, 2.0, 0.009)


@pytest.mark.parametrize("n,want", [
    (1024, "cuda"), (16_384, "cuda"), (24_577, "cuda"), (49_152, "cuda"), (2**20, "cuda"), (2**21, "cuda"),
    (2**23, "cuda"), (2**24, "cuda"), (2**28, "cuda"),
])
def test_shipped_table_kv_crossover(shipped, n, want):
    # the H100's measured routes, at the calibration's host speed: K3 up to
    # its limit, then the histogram and the passes in one library call,
    # faster than torch.sort's route at every size (no crossover left)
    assert router._sort_backend(None, T, n, 1, 4) == want


@pytest.mark.parametrize("n", [24_577, 2**16, 2**18, 2**20, 2**22])
def test_shipped_table_routes_every_sort_to_the_engine(shipped, n):
    # on the H100 the engine's one library call a sort beats torch.sort's
    # route at every size and form; torch's call takes every reduce to 2^28
    assert router._sort_backend(None, T, n, 1, 4) == "cuda"
    assert router._sort_backend(None, T, n, 0, 4) == "cuda"
    assert router._sort_backend(None, T, n, 2, 4) == "cuda"
    assert router._sort_backend(None, T, n, 1, 1, False) == "cuda"
    assert router._u64_backend(None, T, n, 4, 4, 0) == "cuda"
    assert router._segmented_backend(None, T, n, 4, 2) == "cuda"
    assert router._reduce_backend(None, torch.zeros(n)) == "torch"


def test_chained_sorts_overlap_the_second_fixed_time(on_card):
    # u64 keys and segments chain two engine sorts: the second's fixed time
    # is spent on the host while the card runs the first
    m = router._CostModel(FIXTURE)
    one = router._cuda_sort_est_s(m, 2**17, 2, 4)
    assert router._chain_est_s(m, 2**17, (2, 4), (2, 4)) == pytest.approx(2 * one - 130e-6)
    assert router._chain_est_s(m, 2**10, (2, 4), (2, 4)) == pytest.approx(
        2 * router._cuda_sort_est_s(m, 2**10, 2, 4) - 30e-6)
    assert router._chain_est_s(m, 2**16, (2, 4), (2, 4)) == pytest.approx(  # K3 on a cluster
        2 * router._cuda_sort_est_s(m, 2**16, 2, 4) - 40e-6)
    assert router._chain_est_s(m, 2**17, (2, 4), (2, 0)) == pytest.approx(one)


def test_ties_go_to_the_engine(on_card):
    # torch.sort takes a sort only where the model has it faster by more
    # than TORCH_MARGIN
    m = router._CostModel(FIXTURE)
    router._models[None] = m
    assert router._faster(1.0, 1.0 + router.TORCH_MARGIN) == "cuda"
    assert router._faster(1.0, 1.0 + 1.01 * router.TORCH_MARGIN) == "torch"
    assert router._faster(1.0, 0.5) == "cuda"


def test_shipped_table_pruned_and_wide(shipped):
    assert router._sort_backend(None, T, 2**24, 1, 1, False) == "cuda"
    assert router._sort_backend(None, T, 2**28, 0, 4) == "cuda"
    assert router._u64_backend(None, T, 2**24, 4, 4, 0) == "cuda"
    assert router._segmented_backend(None, T, 2**24, 4, 2) == "cuda"
    assert router._H100_MODEL["device"] == "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------------------
# routed end to end, against glu_tpu's backend="xla"
# ---------------------------------------------------------------------------

ALL_TORCH = dict(FIXTURE, k3_fixed_us=1e9, onesweep_fixed_us=1e9, reduce_torch_max_n=2**40)
ALL_CUDA = dict(FIXTURE, torch_ns_per_key={f: [[10, 1e9], [28, 1e9]] for f in router.TORCH_FORMS})


@pytest.fixture
def counted(monkeypatch):
    """Counts of the engine's sorts and of K5's reduces, on the CPU."""
    calls = {"engine": 0, "reduce": 0}
    sort, fold = cs.sort_streams, cr.reduce_partitions

    def engine(*a, **k):
        calls["engine"] += 1
        return sort(*a, **k)

    def reduce_partitions(*a, **k):
        calls["reduce"] += 1
        return fold(*a, **k)

    monkeypatch.setattr(cs, "sort_streams", engine)
    monkeypatch.setattr(cr, "reduce_partitions", reduce_partitions)
    monkeypatch.setattr(cs, "TILE", 256)
    monkeypatch.setattr(cs, "SINGLE_TILE_MAX", 512)
    return calls


def _u32(rng, n: int) -> np.ndarray:
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _cases(rng):
    n = 3000
    k, v = _u32(rng, n), np.arange(n, dtype=np.uint32)
    k64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k64[::3] &= np.uint64((1 << 40) - 1)
    offs = np.r_[0, np.sort(rng.integers(0, n + 1, 40)), n].astype(np.int64)
    return {
        "radix_sort": ((k, v), {}),
        "radix_sort bits=auto": ((k & np.uint32(0xFFF), v), {"bits": "auto"}),
        "radix_sort_u64": ((k64, v), {}),
        "radix_sort_segmented": ((k, v), {"offsets": offs}),
        "reduce": ((k,), {}),
    }


@pytest.mark.parametrize("route", ["cuda", "torch"])
@pytest.mark.parametrize("case", ["radix_sort", "radix_sort bits=auto", "radix_sort_u64", "radix_sort_segmented",
                                  "reduce"])
def test_routed_end_to_end(on_card, counted, route, case):
    on_card(ALL_CUDA if route == "cuda" else ALL_TORCH)
    args, kw = _cases(np.random.default_rng(91))[case]
    fn_name = case.split()[0]
    jfn = getattr(glu_tpu, fn_name)
    if "offsets" in kw:
        want = jax.jit(lambda a, b, o: jfn(a, b, offsets=o, backend="xla"))(*map(jnp.asarray, args),
                                                                           jnp.asarray(kw["offsets"]))
    elif kw.get("bits") == "auto":
        want = jfn(*map(jnp.asarray, args), backend="xla", **kw)
    else:
        want = jax.jit(lambda *a: jfn(*a, backend="xla"))(*map(jnp.asarray, args))
    targs = [from_numpy(a, "cpu") for a in args]
    got = getattr(glu_tpu_torch, fn_name)(*targs, **{k: (from_numpy(v, "cpu") if isinstance(v, np.ndarray) else v)
                                                     for k, v in kw.items()})
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = to_numpy(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8))
    key = "reduce" if case == "reduce" else "engine"
    assert (counted[key] > 0) == (route == "cuda"), counted


@pytest.mark.parametrize("model", ["all torch", "all cuda"])
def test_segmented_reduce_is_not_routed(on_card, monkeypatch, model):
    # its integer SUM is one inclusive scan, which has no router: K4 (its
    # plain version on the CPU) whatever the model, as in the JAX package
    from glu_tpu_torch.ops import _cuda_scan

    on_card(ALL_TORCH if model == "all torch" else ALL_CUDA)
    scans = []
    scan = _cuda_scan.exclusive_scan_partitions
    monkeypatch.setattr(_cuda_scan, "exclusive_scan_partitions", lambda *a, **k: scans.append(1) or scan(*a, **k))
    rng = np.random.default_rng(93)
    x = _u32(rng, 3000)
    offs = np.r_[0, np.sort(rng.integers(0, 3001, 40)), 3000].astype(np.int64)
    want = jax.jit(lambda a, o: glu_tpu.segmented_reduce(a, o, backend="xla"))(jnp.asarray(x), jnp.asarray(offs))
    got = glu_tpu_torch.segmented_reduce(from_numpy(x, "cpu"), from_numpy(offs, "cpu"))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    assert len(scans) == 1
