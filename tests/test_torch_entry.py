"""The port's entry points (glu_tpu_torch/entry.py) against __graft_entry__.py.

`entry()`'s fn and the JAX package's fn get the same u32 pairs, as numpy
arrays (torch's generator is not JAX's, so each side's example inputs go
through both), and must agree bit for bit. `dryrun_multichip` runs once,
over 2 gloo processes: a spawning test costs tens of CPU-seconds, so this
file spawns no other. Without a card, both entry points raise GluError
before they make a tensor or start a process.
"""

import pathlib
import queue
import sys

import numpy as np
import pytest
import torch

from glu_tpu_torch import GluError, from_numpy, to_numpy
from glu_tpu_torch import entry as tentry

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def graft_entry():
    sys.path.insert(0, str(ROOT))
    try:
        import __graft_entry__

        yield __graft_entry__
    finally:
        sys.path.remove(str(ROOT))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_entry_example_inputs():
    fn, (keys, values) = tentry.entry(device="cpu")
    assert keys.dtype == values.dtype == torch.uint32
    assert keys.shape == values.shape == (tentry.ENTRY_N,) == (65536,)
    assert keys.device.type == values.device.type == "cpu"
    np.testing.assert_array_equal(to_numpy(values), np.arange(65536, dtype=np.uint32))
    _, (again, _) = tentry.entry(device="cpu")
    np.testing.assert_array_equal(to_numpy(keys), to_numpy(again))  # seeded: the same keys every call
    assert len(np.unique(to_numpy(keys))) > 65000


@pytest.mark.parametrize("inputs", ["jax", "port"])
def test_entry_fn_matches_graft_entry(graft_entry, inputs):
    """Both fns on the same pairs, bit for bit: the JAX example's pairs and
    the port's."""
    jfn, jargs = graft_entry.entry()
    fn, targs = tentry.entry(device="cpu")
    keys, values = (np.array(a) for a in jargs) if inputs == "jax" else (to_numpy(a) for a in targs)
    want_k, want_v = (np.asarray(a) for a in jfn(keys, values))
    got_k, got_v = fn(from_numpy(keys, "cpu"), from_numpy(values, "cpu"))
    assert got_k.dtype == got_v.dtype == torch.uint32
    np.testing.assert_array_equal(to_numpy(got_k), want_k)
    np.testing.assert_array_equal(to_numpy(got_v), want_v)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(want_v, values[order])


def test_entry_resolves_its_backend_once(monkeypatch):
    """The backend is fixed when entry() is called: a later override in the
    environment does not move fn."""
    monkeypatch.setenv("GLU_TPU_TORCH_BACKEND", "torch")
    fn, args = tentry.entry(device="cpu")
    monkeypatch.setenv("GLU_TPU_TORCH_BACKEND", "nope")
    out = fn(*args)
    assert out[0].shape == args[0].shape


def test_entry_without_a_card_raises(no_card):
    with pytest.raises(GluError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_multichip_over_gloo():
    tentry.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("cards", [0, 1])
def test_dryrun_multichip_without_enough_cards_raises_before_spawning(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)

    def no_spawn(*args, **kwargs):
        raise AssertionError("a process was started")

    monkeypatch.setattr(tentry.mp, "get_context", no_spawn)
    with pytest.raises(GluError):
        tentry.dryrun_multichip(2)


@pytest.mark.parametrize("n, device", [(0, "cpu"), (1.5, "cpu"), (2, "meta")])
def test_dryrun_multichip_rejects_bad_arguments(monkeypatch, n, device):
    monkeypatch.setattr(tentry.mp, "get_context", lambda *a: pytest.fail("a process was started"))
    with pytest.raises(GluError):
        tentry.dryrun_multichip(n, device=device)


class _FakeProcess:
    def __init__(self, alive=True, exitcode=None):
        self.alive, self.exitcode = alive, exitcode

    def is_alive(self):
        return self.alive


def _answers(*items):
    q = queue.Queue()
    for item in items:
        q.put(item)
    return q


def test_await_ranks_returns_when_every_rank_answered():
    tentry._await_ranks([_FakeProcess(False, 0), _FakeProcess(False, 0)], _answers((1, None), (0, None)), 1e18)


@pytest.mark.parametrize("case", ["failure", "dead rank", "deadline"])
def test_await_ranks_raises_at_once(case):
    """A rank's failure, a rank that ended without answering and a rank that
    never answers each fail the wait, the first two without waiting for
    the deadline."""
    procs = [_FakeProcess(), _FakeProcess()]
    if case == "failure":
        answers, match = _answers((0, None), (1, "Traceback: boom")), "rank 1 of 2 failed:\nTraceback: boom"
    elif case == "dead rank":
        procs[1] = _FakeProcess(alive=False, exitcode=-9)
        answers, match = _answers((0, None)), "rank 1 of 2 ended with exit code -9"
    else:
        answers, match = _answers((0, None)), r"ranks \[1\] of 2 did not answer in time"
    deadline = 0.0 if case == "deadline" else 1e18
    with pytest.raises(GluError, match=match):
        tentry._await_ranks(procs, answers, deadline)
