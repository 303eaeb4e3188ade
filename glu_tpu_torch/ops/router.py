"""The router: a per-device cost model that picks the backend of a sort or a
reduce when the caller asked for none (counterpart of the router in
glu_tpu/ops/radix_sort.py:44-211, :497-513, :683-700 and of
glu_tpu/ops/reduce.py::_reduce_backend).

No fixed choice is right on every card and host: the engine's multi-tile
sort pays a fixed time a call (the host's call, the launches' latency and
each pass's chain of tiles) that torch.sort's route may undercut at small
sizes, while the reduce of a few elements is faster through torch's own
call. So a sort or reduce of a CUDA tensor given `backend=None`, with
GLU_TPU_TORCH_BACKEND unset (ops/backend.py::routable), runs whichever
backend the model says is faster; a sort goes to torch only where the model
has it faster by more than TORCH_MARGIN (`_faster`). On the H100 the
engine wins every sort size (since the whole multi-tile sort became one
library call) and torch's call every reduce up to 2^28. The model is a dict
of measured rates, one per card: the calibration file when it exists and
parses (`router_calibration_path()`, written by `python -m
glu_tpu_torch.ops.router --calibrate`), else the shipped table measured on
an H100 (`_H100_MODEL`). It is read once per device and kept.

The model's form is the engine's (ops/_cuda_sort.py): up to SINGLE_TILE_MAX
pairs K3 alone, costing a fixed time (the wrapper's host time) plus n x
passes x a rate, one pair of them for one CTA (up to CTA_MAX) and one for a
cluster of CTAs (the cluster's barriers and its stores into the other CTAs'
shared memory); above it one histogram launch and one onesweep pass per 8
key bits, costing the larger of a fixed time plus a time a pass (the
host's call and the launches' latency) and the card's (n x (the
histogram's rate + passes x the pass's rate)). The
per-key rates are given for 0, 1 and 2 payloads and extended linearly past
2. The torch side is a table of ns per key by log2 n of each form of the
"torch" backend's core sort (key/value, keys only, two payloads, the int64
sort of u64 keys, the (segment, key) sort), interpolated geometrically
between its points and extended past its end by a slope, plus a masking
pass where the sorted bits are not the whole key. Work that both backends
do alike (float and signed key transforms, the u64 word split and join,
segment ids, gathers of payloads past the seventh) is not counted. Two
chained engine sorts (u64 keys, segments) cost their sum less the second's
fixed time, spent on the host while the card runs the first. The model is
read as it was measured: the host's speed moves from one second to the
next on the H100's machines, by more than any probe taken once can tell
(PERF.md), and since the engine's sort is one library call no route on
the H100 turns on it.

The router chooses before the call, from the model; it never retries a
failed kernel on torch. The scans have no router, as in the JAX package:
they take the override or "cuda".
"""

from __future__ import annotations

import bisect
import importlib
import json
import math
import os
import subprocess
import sys
import time

import torch

from ..utils.errors import check_argument
from ..utils.log import vlog
from ..utils.timing import count, start, stop
from . import _cuda_sort as cs
from . import backend as _backend

# The shipped model: the output of one full `python -m glu_tpu_torch.ops.router
# --calibrate` on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, pasted in
# (PERF.md, section 5, names the run). Times in us, rates in ns a key; torch's
# tables are [log2 n, ns a key] points.
_H100_MODEL = {
    "device": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "k3_fixed_us": 48.474,
    "k3_ns_per_key_pass": [0.50313, 0.58125, 1.2703],
    "k3_cluster_fixed_us": 69.493,
    "k3_cluster_ns_per_key_pass": [0.15283, 0.16764, 0.23226],
    "onesweep_fixed_us": 56.331,
    "onesweep_pass_us": 17.077,
    "onesweep_hist_ns_per_key": 0.0045567,
    "onesweep_ns_per_key_pass": [0.0087576, 0.0098899, 0.014531],
    "torch_ns_per_key": {
        "keys": [
            [10.0, 86.562], [12.0, 23.422], [14.0, 6.3594], [15.0, 3.3564], [16.0, 1.7114], [16.000022, 1.665],
            [17.0, 0.83105], [18.0, 0.42383], [20.0, 0.14789], [22.0, 0.091736], [24.0, 0.085606], [26.0, 0.091563],
            [28.0, 0.090247],
        ],
        "kv": [
            [10.0, 90.781], [12.0, 23.469], [14.0, 6.6348], [15.0, 3.4639], [16.0, 1.771], [16.000022, 1.873],
            [17.0, 0.85913], [18.0, 0.4563], [20.0, 0.16495], [22.0, 0.10208], [24.0, 0.111], [26.0, 0.12458],
            [28.0, 0.12617],
        ],
        "multi2": [
            [10.0, 119.41], [12.0, 28.344], [14.0, 7.2129], [15.0, 3.5117], [16.0, 1.8071], [16.000022, 1.8022],
            [17.0, 0.98804], [18.0, 0.52197], [20.0, 0.18335], [22.0, 0.11366], [24.0, 0.13539], [26.0, 0.15837],
            [28.0, 0.16177],
        ],
        "u64": [
            [10.0, 170.78], [12.0, 47.398], [14.0, 13.541], [15.0, 6.7842], [16.0, 3.4224], [16.000022, 3.6479],
            [17.0, 1.812], [18.0, 0.91553], [20.0, 0.35721], [22.0, 0.22616], [24.0, 0.24047], [26.0, 0.26618],
        ],
        "segmented": [
            [10.0, 170.44], [12.0, 47.695], [14.0, 13.398], [15.0, 6.8437], [16.0, 3.585], [16.000022, 3.5278],
            [17.0, 2.0225], [18.0, 0.93823], [20.0, 0.32623], [22.0, 0.2218], [24.0, 0.18338], [26.0, 0.17985],
        ],
    },
    "torch_slope": {"keys": 0.0, "kv": 0.000795, "multi2": 0.0017, "u64": 0.012855, "segmented": 0.0},
    "compact_us": 0.608,
    "compact_ns_per_key": 0.0,
    "reduce_torch_max_n": 268435456,
}

_ENV_CALIBRATION = "GLU_TPU_TORCH_ROUTER_CALIBRATION"
TORCH_MARGIN = 0.20  # a sort goes to torch only where the model has it faster by more than this
TORCH_FORMS = ("keys", "kv", "multi2", "u64", "segmented")


def router_calibration_path() -> str:
    """GLU_TPU_TORCH_ROUTER_CALIBRATION, or $XDG_CACHE_HOME (default
    ~/.cache)/glu_tpu_torch/router.json."""
    p = os.environ.get(_ENV_CALIBRATION)
    if p:
        return p
    return os.path.join(
        os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")), "glu_tpu_torch", "router.json"
    )


class _CostModel:
    """A model dict in the form the estimates read: per-payload tuples and,
    for each torch form, (log2 n points, log ns/key points, slope)."""

    def __init__(self, model: dict):
        self.model = model
        self.k3_fixed_us = float(model["k3_fixed_us"])
        self.k3_ns = tuple(model["k3_ns_per_key_pass"])
        self.k3_cluster_fixed_us = float(model["k3_cluster_fixed_us"])
        self.k3_cluster_ns = tuple(model["k3_cluster_ns_per_key_pass"])
        self.os_fixed_us = float(model["onesweep_fixed_us"])
        self.os_pass_us = float(model["onesweep_pass_us"])
        self.hist_ns = float(model["onesweep_hist_ns_per_key"])
        self.os_ns = tuple(model["onesweep_ns_per_key_pass"])
        self.torch = {}
        for form in TORCH_FORMS:
            pts = sorted(model["torch_ns_per_key"][form])
            self.torch[form] = (
                [float(lg) for lg, _ in pts],
                [math.log(ns) for _, ns in pts],
                float(model["torch_slope"][form]),
            )
        self.compact_us = float(model["compact_us"])
        self.compact_ns = float(model["compact_ns_per_key"])
        self.reduce_torch_max_n = int(model["reduce_torch_max_n"])


_models: dict = {}  # device index (None for the CPU) -> _CostModel


def _cost_model(device: torch.device) -> _CostModel:
    m = _models.get(device.index)
    if m is None:
        m = _models[device.index] = _CostModel(_load_model(device))
    return m


def _router_model(device=None) -> dict:
    """The active cost model of `device` (default: the current CUDA device):
    the calibration file if it exists and parses, else the shipped H100
    table, read once per device. vlog names the source, and warns when the
    model was measured on another card than this one."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _cost_model(device).model


def _load_model(device: torch.device) -> dict:
    path = router_calibration_path()
    model = dict(_H100_MODEL)
    if os.path.exists(path):
        try:
            with open(path) as f:
                model.update(json.load(f))
            vlog("router: loaded calibration %s (device: %s)", path, model.get("device"))
        except (OSError, ValueError) as e:
            vlog("router: unreadable calibration %s (%s); using the shipped H100 table", path, e)
    else:
        vlog("router: no calibration at %s; using the shipped H100 table "
             "(run `python -m glu_tpu_torch.ops.router --calibrate` on another card)", path)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        if model.get("device") != name:
            vlog("router: WARNING: the model was measured on %s, this card is %s; "
                 "run `python -m glu_tpu_torch.ops.router --calibrate`", model.get("device"), name)
    return model


def _reset_router_model() -> None:
    """Drop the cached models (tests point GLU_TPU_TORCH_ROUTER_CALIBRATION
    at fixture files and must read them again)."""
    _models.clear()


# ---------------------------------------------------------------------------
# the estimates
# ---------------------------------------------------------------------------


def _per_payloads(values: tuple, payloads: int) -> float:
    """A rate given for 0, 1 and 2 payloads, extended past 2 by the step
    from 1 to 2."""
    if payloads <= 2:
        return values[payloads]
    return values[2] + (payloads - 2) * (values[2] - values[1])


def _table_s(table, n: int) -> float:
    """Seconds of n keys by a (log2 n, log ns/key, slope) table: geometric
    between its points, constant time below its first, ns/key growing by
    `slope` a doubling past its last."""
    lgs, log_ns, slope = table
    lg = math.log2(n) if n > 1 else 0.0
    if lg <= lgs[0]:
        return math.exp(log_ns[0]) * 2.0 ** lgs[0] * 1e-9
    if lg >= lgs[-1]:
        return n * (math.exp(log_ns[-1]) + slope * (lg - lgs[-1])) * 1e-9
    i = bisect.bisect_left(lgs, lg)
    x0, x1 = lgs[i - 1], lgs[i]
    return n * math.exp(log_ns[i - 1] + (log_ns[i] - log_ns[i - 1]) * (lg - x0) / (x1 - x0)) * 1e-9


def _compact_s(m: _CostModel, n: int) -> float:
    """The "torch" backend's masking of the key to the sorted bits."""
    return (m.compact_us + n * m.compact_ns * 1e-3) * 1e-6


def _torch_sort_est_s(m: _CostModel, n: int, num_streams: int, full_cover: bool = True) -> float:
    """Estimated seconds of the "torch" backend's sort of n keys with
    num_streams payloads (radix_sort.py::_sort_torch): one stable
    torch.sort and a gather a payload."""
    if num_streams == 0:
        t = _table_s(m.torch["keys"], n)
    else:
        t = _table_s(m.torch["kv"], n)
        if num_streams > 1:
            t += (num_streams - 1) * (_table_s(m.torch["multi2"], n) - t)
    return t if full_cover else t + _compact_s(m, n)


def _cuda_sort_est_s(m: _CostModel, n: int, num_streams: int, npasses: int) -> float:
    """Estimated seconds of the engine's sort of n keys with num_streams
    payloads in npasses passes of up to 8 bits: K3 alone up to
    SINGLE_TILE_MAX (its host time, then its one launch, on one CTA or a
    cluster), else one histogram and npasses onesweep passes (the host's
    time or the card's, whichever is longer)."""
    if npasses == 0 or n <= 1:
        return 0.0
    if n <= cs.SINGLE_TILE_MAX:
        fixed_us, rates = _k3_terms(m, n)
        return (fixed_us + n * npasses * _per_payloads(rates, num_streams) * 1e-3) * 1e-6
    # the host launches each pass while the card runs the one before, so the
    # call takes the longer of the two (a sum overestimated 2^22 pairs by a
    # third on the H100, past torch's time, where the engine was faster)
    host_s = (m.os_fixed_us + npasses * m.os_pass_us) * 1e-6
    return max(host_s, n * (m.hist_ns + npasses * _per_payloads(m.os_ns, num_streams)) * 1e-9)


def _chain_est_s(m: _CostModel, n: int, first: tuple, second: tuple) -> float:
    """Estimated seconds of two engine sorts of n keys run one after the
    other, each given as (payloads, passes): their sum less the second's
    fixed time, which the host spends while the card runs the first's
    passes."""
    a, b = _cuda_sort_est_s(m, n, *first), _cuda_sort_est_s(m, n, *second)
    if a == 0.0 or b == 0.0:
        return a + b
    fixed = _k3_terms(m, n)[0] if n <= cs.SINGLE_TILE_MAX else m.os_fixed_us
    return a + b - min(fixed * 1e-6, b)


def _k3_terms(m: _CostModel, n: int) -> tuple:
    """K3's (fixed us, ns a key a pass by payloads) at n: one CTA's up to
    CTA_MAX, the cluster's above."""
    if n <= cs.CTA_MAX:
        return m.k3_fixed_us, m.k3_ns
    return m.k3_cluster_fixed_us, m.k3_cluster_ns


def _npasses_of(positions: tuple) -> int:
    """The engine's passes over these key bits: one per 8 of them."""
    return -(-len(positions) // cs.MAX_FIELD_BITS)


# ---------------------------------------------------------------------------
# the routers
# ---------------------------------------------------------------------------


def _faster(torch_s: float, cuda_s: float) -> str:
    """The route of a sort by its two estimates: "torch" only where the
    model has it faster than the engine by more than TORCH_MARGIN. Within
    that the estimates cannot tell the backends apart, and a tie goes to
    the engine: where both are bound by their fixed times, the host's speed,
    which moves by up to 2x from one second to the next on the H100's
    machines, moves torch.sort's route (several launches and allocations)
    more than the engine's one library call, so that a calibration taken at
    a fast moment can read torch.sort's route the faster where later calls
    find it the slower (PERF.md §6, PR 10: the largest margin a model needed
    in five runs of the guard was 0.127).
    """
    return "torch" if torch_s * (1 + TORCH_MARGIN) < cuda_s else "cuda"


def _routed(op: str, backend: str) -> str:
    """Counts the route of one decision (route.<op>.<backend>) and returns it."""
    count(f"route.{op}.{backend}")
    return backend


def _sort_backend(backend, tensor: torch.Tensor, n: int, num_streams: int, npasses: int,
                  full_cover: bool | None = None) -> str:
    """The backend of a sort of n keys of `tensor` with num_streams
    payloads in npasses 8-bit passes; full_cover: whether the sorted bits
    are the whole key (default: 4 passes), else the "torch" backend masks
    the key first. Routed only where ops/backend.py::routable says so."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, tensor):
            return _routed("sort", _backend.resolve_backend(backend, tensor))
        m = _cost_model(tensor.device)
        if num_streams >= cs.MAX_STREAMS:  # both backends sort an index and gather the payloads by it
            num_streams = 1
        if full_cover is None:
            full_cover = npasses >= cs.MAX_PASSES
        torch_s = _torch_sort_est_s(m, n, num_streams, full_cover)
        return _routed("sort", _faster(torch_s, _cuda_sort_est_s(m, n, num_streams, npasses)))
    finally:
        stop(opened)


def _u64_backend(backend, tensor: torch.Tensor, n: int, p_hi: int, p_lo: int, extra_ops: int) -> str:
    """The backend of a sort of n u64 keys (radix_sort.py::_sort_two_words):
    the engine chains a sort of the low word and one of the high word, each
    carrying 2 payloads, in p_lo and p_hi passes (0: no bit of that word is
    sorted); "torch" sorts once on the int64 key, masking `extra_ops` words."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, tensor):
            return _routed("u64", _backend.resolve_backend(backend, tensor))
        m = _cost_model(tensor.device)
        torch_s = _table_s(m.torch["u64"], n) + extra_ops * _compact_s(m, n)
        return _routed("u64", _faster(torch_s, _chain_est_s(m, n, (2, p_lo), (2, p_hi))))
    finally:
        stop(opened)


def _segmented_backend(backend, tensor: torch.Tensor, n: int, key_passes: int, seg_passes: int,
                       full_cover: bool = True) -> str:
    """The backend of a segmented sort of n keys: the engine chains the key
    sort (key_passes) and the segment-id sort (seg_passes), each carrying 2
    payloads; "torch" sorts once on the int64 of (segment id, key), masking
    the key unless full_cover."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, tensor):
            return _routed("segmented", _backend.resolve_backend(backend, tensor))
        m = _cost_model(tensor.device)
        torch_s = _table_s(m.torch["segmented"], n) + (0.0 if full_cover else _compact_s(m, n))
        return _routed("segmented", _faster(torch_s, _chain_est_s(m, n, (2, key_passes), (2, seg_passes))))
    finally:
        stop(opened)


def _reduce_backend(backend, x: torch.Tensor) -> str:
    """The backend of a reduce of x: "torch" up to the model's
    reduce_torch_max_n elements (the calibration's sizes up to which
    torch's call beat K5 at every one in every reading; 0 where it did not
    at the smallest, which makes this the constant "cuda"), "cuda" above. segmented_reduce is not routed: its integer SUM is a scan."""
    opened = start("glu.route")
    try:
        if not _backend.routable(backend, x):
            return _routed("reduce", _backend.resolve_backend(backend, x))
        return _routed("reduce", "torch" if x.numel() <= _cost_model(x.device).reduce_torch_max_n else "cuda")
    finally:
        stop(opened)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

# sizes of the calibration ladder: doublings, and around the K3 limit
# (65,536); the engine's sorts are timed where K3 leaves one CTA (CTA_MAX) too
LADDER = (1 << 10, 1 << 12, 1 << 14, 1 << 15, 1 << 16, 65537, 1 << 17, 1 << 18,
          1 << 20, 1 << 22, 1 << 24, 1 << 26, 1 << 28)
QUICK_MAX = 1 << 26  # --quick stops here
TWO_WORD_MAX = 1 << 26  # the u64 and segmented forms stop here
HOST_BOUND_MAX = 1 << 20  # the engine's 1-pass sorts are timed up to here, and all sizes to here at once
REDUCE_READINGS = 5  # the reduce's two backends are timed this many times a size
SEGMENTS = 4096
SEED = 20260
# the guard: a routed call is within this of the faster backend's time
GUARD_REL = 0.10
GUARD_ABS_MS = 0.010


def within_guard(routed_ms: float, cuda_ms: float, torch_ms: float) -> bool:
    """True when the routed time is within 10% plus 0.010 ms of the faster
    backend's."""
    return routed_ms <= (1 + GUARD_REL) * min(cuda_ms, torch_ms) + GUARD_ABS_MS


def l2_flush(device: torch.device):
    """A function that evicts the card's 50 MB L2 cache (a write of 128 MB)
    and waits for it: called before each timed call, so that every call
    finds its inputs in device memory, whichever call ran before it."""
    scratch = torch.empty(1 << 25, dtype=torch.int32, device=device)

    def flush() -> None:
        scratch.zero_()
        torch.cuda.synchronize(device)

    return flush


def _event_timer(device: torch.device):
    """The calibration's timer on the card: for a dict of calls, the
    seconds of one call of each, timed one call at a time in rounds that
    visit every call in a new order (seeded), so that the host's drift and
    the cost of following the other backend fall on every call alike: each
    after an L2 flush, between CUDA events, followed by a sync; the median
    (a warm-up first)."""
    import random

    flush = l2_flush(device)
    shuffle = random.Random(SEED).shuffle

    def timer(calls: dict) -> dict:
        points = list(calls)
        rounds = 21 if max(p[2] for p in points) <= 1 << 20 else 5
        for fn in calls.values():
            fn()
        times = {p: [] for p in points}
        for _ in range(rounds):
            shuffle(points)
            for p in points:
                flush()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                calls[p]()
                end.record()
                end.synchronize()
                times[p].append(start.elapsed_time(end))
        return {p: sorted(t)[rounds // 2] * 1e-3 for p, t in times.items()}

    return timer


def _power_limit_w(device: torch.device):
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sig(x: float) -> float:
    """x to 5 significant digits (a onesweep pass is about 0.0085 ns/key)."""
    return float(f"{x:.5g}")


def calibrate(device=None, ladder=None, timer=None, *, quick: bool = False, out: str | None = None,
              echo=print) -> dict:
    """Measure the router's model on `device` (default: the card) and write
    it to `out` (default: router_calibration_path()); returns the model.

    Both backends of each form are timed over `ladder` (default LADDER;
    quick: up to 2^26; u64 and segmented up to 2^26), the engine also at
    CTA_MAX / 2, CTA_MAX and SINGLE_TILE_MAX (so that K3 on one CTA has two
    sizes whatever the ladder), and at 1 pass with 0, 1 and 2 payloads at
    the sizes above SINGLE_TILE_MAX up to 2^20 and at the largest up to
    2^26, which fix its fixed times and rates, and the reduce
    REDUCE_READINGS times. `timer(calls)` takes a dict of functions by point, (backend,
    form, n, passes), and returns the seconds of one call of each; the calls
    of every size up to HOST_BOUND_MAX are timed together, those of each
    larger size together. The default times on the card as
    chip_smoke.py's guard does (in rounds, each call after an L2 flush,
    between CUDA events; the median). `echo` gets one line per
    measurement."""
    from ..utils.buffers import default_device
    from .reduce import ReduceOperator, _reduce_impl

    rs = importlib.import_module(__package__ + ".radix_sort")  # the module; the package re-exports a function of its name

    device = default_device(device)
    if timer is None:
        check_argument(device.type == "cuda", "calibration times the card: pass timer= to calibrate on %s", device)
        timer = _event_timer(device)
    sizes = sorted(set(LADDER if ladder is None else ladder))
    if quick:
        sizes = [n for n in sizes if n <= QUICK_MAX]
    k3_n, cta_n = cs.SINGLE_TILE_MAX, min(cs.CTA_MAX, cs.SINGLE_TILE_MAX)
    above = [n for n in sizes if k3_n < n <= TWO_WORD_MAX]
    check_argument(len(above) >= 2, "the ladder needs two sizes from SINGLE_TILE_MAX (%d) to 2^26", k3_n)
    n_big = above[-1]
    top = max(sizes[-1], k3_n)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    words = torch.randint(-(2**31), 2**31, (top,), dtype=torch.int32, device=device, generator=gen)
    words2 = torch.randint(-(2**31), 2**31, (top,), dtype=torch.int32, device=device, generator=gen)
    iota = torch.arange(top, dtype=torch.int32, device=device)
    full, one_pass = rs.FULL, tuple(range(cs.MAX_FIELD_BITS))
    streams_of = {"keys": 0, "kv": 1, "multi2": 2}
    measured: dict = {}

    def measure(calls: dict) -> dict:
        got = timer(calls)
        for point, s in got.items():
            measured[point] = s
            echo(f"calibrate {point[0]} {point[1]} n={point[2]}"
                 f"{'' if point[3] is None else f' passes={point[3]}'}: {s * 1e3:.4f} ms")
        return got

    def sort_fn(b, form, n, positions):
        k, pays = words[:n], [iota[:n], words2[:n]][: streams_of[form]]
        if b == "torch":
            return lambda: rs._sort_torch(k, pays, positions)
        return lambda: rs._radix_sort_streams(k, pays, positions, "cuda")

    def two_word_fn(b, form, n):
        if form == "u64":
            major, minor, major_pos = words[:n], words2[:n], full
        else:
            major = (iota[:n].to(torch.int64) * SEGMENTS // n).to(torch.int32)
            minor, major_pos = words[:n], rs._seg_bits(SEGMENTS)
        return lambda: rs._sort_two_words(major, minor, major_pos, full, [iota[:n]], b)

    # the calls of each size, with the engine's 1-pass sorts beside its full
    # ones where the fit compares them: at the sizes where the multi-tile
    # path is bound by its fixed time, and at n_big. Every
    # size up to HOST_BOUND_MAX is timed in one group, so that each point's
    # median is taken over the same moments of the host, whose speed moves
    # by up to 2x from one second to the next on the H100's machines:
    # torch's route is host-bound there, and timed a size at a time, one
    # size that met a fast moment would be set against the engine's fixed
    # time, a median pooled over all the sizes. The larger sizes, a call of
    # which is up to 1,000x longer, a size at a time.
    one_pass_sizes = {n_big} | {n for n in sizes if k3_n < n <= HOST_BOUND_MAX}
    host_bound = {}
    for n in sorted(set(sizes) | {cta_n // 2, cta_n, k3_n}):
        calls = {}
        for form in ("keys", "kv", "multi2"):
            if n in sizes:
                calls[("torch", form, n, None)] = sort_fn("torch", form, n, full)
            calls[("cuda", form, n, cs.MAX_PASSES)] = sort_fn("cuda", form, n, full)
            if n in one_pass_sizes:
                calls[("cuda", form, n, 1)] = sort_fn("cuda", form, n, one_pass)
        if n in one_pass_sizes and n > k3_n:  # the masking of the key, by difference
            calls[("torch", "kv", n, 1)] = sort_fn("torch", "kv", n, one_pass)
        if n <= TWO_WORD_MAX and n in sizes:
            for form in ("u64", "segmented"):
                for b in ("torch", "cuda"):
                    calls[(b, form, n, None)] = two_word_fn(b, form, n)
        if n <= HOST_BOUND_MAX:
            host_bound.update(calls)
        else:
            measure(calls)
    measure(host_bound)

    model = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
             "power_limit_w": _power_limit_w(device) if device.type == "cuda" else None}
    model.update(_fit_model(measured, sizes, k3_n, cta_n))
    # reduce: K5 and torch's, timed together REDUCE_READINGS times a size,
    # each reading of the two in the same rounds (the host's drift, which
    # moves these times by 2x from one reading to the next on the H100,
    # falls on both). torch wins at a size where it is the faster in every
    # reading; it takes the sizes up to the first at which it does not win
    model["reduce_torch_max_n"], prefix = 0, True
    for n in sizes:
        x = words[:n].view(torch.uint32)
        calls = {(b, "reduce", n, None): (lambda b=b: _reduce_impl(x, ReduceOperator.SUM, b)) for b in ("cuda", "torch")}
        readings = [timer(calls) for _ in range(REDUCE_READINGS)]
        pairs = [(r[("cuda", "reduce", n, None)], r[("torch", "reduce", n, None)]) for r in readings]
        wins = all(t < c for c, t in pairs)
        echo(f"calibrate reduce n={n}: cuda/torch {' '.join(f'{c * 1e3:.4f}/{t * 1e3:.4f}' for c, t in pairs)} ms: "
             f"{'torch wins' if wins else 'torch does not win'}")
        prefix = prefix and wins
        if prefix:
            model["reduce_torch_max_n"] = n

    _echo_model_check(model, measured, sizes, echo)
    path = out or router_calibration_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(model, f, indent=1)
    _reset_router_model()
    echo(f"calibrate: wrote {path}")
    return model


def _fit_model(measured: dict, sizes: list, k3_n: int, cta_n: int) -> dict:
    """The model's rates from calibrate's measurements, a dict of seconds by
    (backend, form, n, passes)."""
    n_big = max(n for n in sizes if k3_n < n <= TWO_WORD_MAX)
    # the engine. K3 on one CTA (up to CTA_MAX) and on a cluster (above):
    # each one's per-key rate a pass by payloads from its full sorts at its
    # smallest and largest sizes, and its fixed time, the median over its
    # points of what the rate leaves (a cluster without two sizes of its
    # own, as where the two limits meet, takes one CTA's terms). Not from 1 and 4
    # passes at one size: each pass also has a fixed part (its scans and, in
    # a cluster, its barriers), which that rate counted as keys and so
    # overestimated the largest sorts (on the H100 by a tenth at 65,536
    # pairs). The multi-tile path: the card's rates by payloads from 1 and 4
    # passes at n_big; the fixed times from the medians of the 1-pass and of
    # the 4-pass sorts where the card's estimate is under half the time:
    # fixed + 1 pass and fixed + 4 passes (the host's call, the launches'
    # latency and the chain of each pass's tiles, which hardly depend on the
    # payloads: pooled over the forms).
    def quantile(values, q):
        values = sorted(values)
        return values[int(q * (len(values) - 1) + 0.5)]

    def median(values):
        return quantile(values, 0.5)

    extra = cs.MAX_PASSES - 1
    forms = ("keys", "kv", "multi2")

    def rate(form, n):  # ns a key a pass of the engine's sort of n keys, from 1 and 4 passes
        t1, t4 = measured[("cuda", form, n, 1)], measured[("cuda", form, n, cs.MAX_PASSES)]
        return max((t4 - t1) / (extra * n), 0.0)

    def k3_terms(lo_n, hi_n):
        """K3's (fixed s, s a key a pass by payloads) from its points in
        (lo_n, hi_n], or None where they are of one size."""
        points = {(form, n, p): t for (b, form, n, p), t in measured.items()
                  if b == "cuda" and form in forms and lo_n < n <= hi_n}
        lo, hi = min(n for _, n, _ in points), max(n for _, n, _ in points)
        if lo == hi:
            return None
        full = {(form, n): t for (form, n, p), t in points.items() if p == cs.MAX_PASSES}
        rates = [max((full[(form, hi)] - full[(form, lo)]) / (cs.MAX_PASSES * (hi - lo)), 0.0) for form in forms]
        return median([t - n * p * rates[forms.index(form)] for (form, n, p), t in points.items()]), rates

    os_ns, hist = [], []
    for form in forms:
        os_ns.append(rate(form, n_big))
        hist.append(measured[("cuda", form, n_big, 1)] / n_big - os_ns[-1])
    hist = max(median(hist), 0.0)
    host = {1: [], cs.MAX_PASSES: []}
    for (b, form, n, p), t in measured.items():
        if b == "cuda" and form in forms and n > k3_n and n * (hist + p * os_ns[forms.index(form)]) < t / 2:
            host[p].append(t)
    one, full = median(host[1]), median(host[cs.MAX_PASSES])
    per_pass = max((full - one) / extra, 0.0)
    k3_fixed, k3_ns = k3_terms(0, cta_n)
    k3c_fixed, k3c_ns = (k3_terms(cta_n, k3_n) if cta_n < k3_n else None) or (k3_fixed, k3_ns)
    model = {
        "k3_fixed_us": _sig(max(k3_fixed, 0.0) * 1e6),
        "k3_ns_per_key_pass": [_sig(r * 1e9) for r in k3_ns],
        "k3_cluster_fixed_us": _sig(max(k3c_fixed, 0.0) * 1e6),
        "k3_cluster_ns_per_key_pass": [_sig(r * 1e9) for r in k3c_ns],
        "onesweep_fixed_us": _sig(max(one - per_pass, 0.0) * 1e6),
        "onesweep_pass_us": _sig(per_pass * 1e6),
        "onesweep_hist_ns_per_key": _sig(hist * 1e9),
        "onesweep_ns_per_key_pass": [_sig(r * 1e9) for r in os_ns],
    }
    # torch: ns/key by log2 n of each form, a slope past the last point
    tables, slopes = {}, {}
    for form in TORCH_FORMS:
        pts = [[round(math.log2(n), 6), _sig(measured[("torch", form, n, None)] / n * 1e9)]
               for n in sizes if ("torch", form, n, None) in measured]
        tables[form] = pts
        slopes[form] = _sig(max((pts[-1][1] - pts[-2][1]) / (pts[-1][0] - pts[-2][0]), 0.0)) if len(pts) > 1 else 0.0
    model["torch_ns_per_key"], model["torch_slope"] = tables, slopes
    # the masking: the torch key/value sort of 8 bits less the full one, timed
    # together; its rate from the smallest and largest of those sizes, its
    # fixed time the median of what the rate leaves
    masked = {n: t - measured[("torch", "kv", n, None)] for (b, f, n, p), t in measured.items()
              if (b, f, p) == ("torch", "kv", 1)}
    lo = min(masked)
    rate = max((masked[n_big] - masked[lo]) / (n_big - lo), 0.0)
    fixed = median([d - n * rate for n, d in masked.items()])
    model["compact_us"], model["compact_ns_per_key"] = _sig(max(fixed, 0.0) * 1e6), _sig(rate * 1e9)
    return model


def _echo_model_check(model: dict, measured: dict, sizes: list, echo) -> None:
    """One line per form and ladder size: the model's estimate of each
    backend beside its measured time, its route and the faster backend."""
    rs = importlib.import_module(__package__ + ".radix_sort")
    check = _CostModel({**_H100_MODEL, **model})
    streams_of = {"keys": 0, "kv": 1, "multi2": 2}
    seg_passes = _npasses_of(rs._seg_bits(SEGMENTS))
    estimates = {
        "keys": lambda n: (_cuda_sort_est_s(check, n, 0, cs.MAX_PASSES), _torch_sort_est_s(check, n, 0)),
        "kv": lambda n: (_cuda_sort_est_s(check, n, 1, cs.MAX_PASSES), _torch_sort_est_s(check, n, 1)),
        "multi2": lambda n: (_cuda_sort_est_s(check, n, 2, cs.MAX_PASSES), _torch_sort_est_s(check, n, 2)),
        "u64": lambda n: (_chain_est_s(check, n, (2, cs.MAX_PASSES), (2, cs.MAX_PASSES)), _table_s(check.torch["u64"], n)),
        "segmented": lambda n: (_chain_est_s(check, n, (2, cs.MAX_PASSES), (2, seg_passes)),
                                _table_s(check.torch["segmented"], n)),
    }
    for n in sizes:
        for form in TORCH_FORMS:
            if ("torch", form, n, None) not in measured:
                continue
            est = estimates[form](n)
            got = (measured[("cuda", form, n, cs.MAX_PASSES if form in streams_of else None)],
                   measured[("torch", form, n, None)])
            echo(f"calibrate model {form} n={n}: cuda {est[0] * 1e3:.4f} ms (measured {got[0] * 1e3:.4f}), "
                 f"torch {est[1] * 1e3:.4f} ms (measured {got[1] * 1e3:.4f}), route "
                 f"{'torch' if est[1] < est[0] else 'cuda'}, faster {'torch' if got[1] < got[0] else 'cuda'}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m glu_tpu_torch.ops.router",
        description="Measure the router's cost model on this card and write the calibration file.",
    )
    ap.add_argument("--calibrate", action="store_true", help="measure and write the model")
    ap.add_argument("--quick", action="store_true", help="a ladder up to 2^26 instead of 2^28")
    ap.add_argument("--out", help=f"where to write it (default: {router_calibration_path()})")
    args = ap.parse_args(argv)
    if not args.calibrate:
        ap.print_help()
        return 2
    print(json.dumps(calibrate(quick=args.quick, out=args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
