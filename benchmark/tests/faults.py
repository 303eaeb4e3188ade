"""Faults planted under the timed path, for test_faults.py: each function
swaps the program's entry points that the cells call for broken ones and
returns the undo. A fault leaves the other entry points alone."""

import torch

import glu_tpu_torch as glu
from glu_tpu_torch import parallel


def _swap(module, name: str, broken) -> callable:
    original = getattr(module, name)
    setattr(module, name, broken(original))
    return lambda: setattr(module, name, original)


def _all(*undos):
    return lambda: [undo() for undo in undos]


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size()


def _even_counts(n: int, device) -> tuple:
    counts = torch.full((_world(),), n, dtype=torch.int32, device=device)
    return counts, torch.zeros_like(counts)


def _flip_first(t: torch.Tensor) -> torch.Tensor:
    w = t.view(torch.int32).clone()
    w.view(-1)[0] ^= 1
    return w.view(t.dtype)


def unchanged():
    """A step that returns its input unchanged."""
    return _all(
        _swap(glu, "radix_sort", lambda f: lambda k, v, *a, **kw: (k, v)),
        _swap(glu, "exclusive_scan", lambda f: lambda x, *a, **kw: x),
        _swap(glu, "reduce", lambda f: lambda x, *a, **kw: x[0]),
        _swap(parallel, "distributed_radix_sort",
              lambda f: lambda k, v, *a, **kw: (k, v, *_even_counts(k.shape[0], k.device))))


def half_batch():
    """Half of the input left out: the call works on its first half."""

    def half(x: torch.Tensor) -> torch.Tensor:
        return x[: x.shape[0] // 2]

    return _all(
        _swap(glu, "radix_sort", lambda f: lambda k, v, *a, **kw: f(half(k), half(v), *a, **kw)),
        _swap(glu, "exclusive_scan", lambda f: lambda x, *a, **kw: f(half(x), *a, **kw)),
        _swap(glu, "reduce", lambda f: lambda x, *a, **kw: f(half(x), *a, **kw)),
        _swap(parallel, "distributed_radix_sort", lambda f: lambda k, v, *a, **kw: f(half(k), half(v), *a, **kw)))


def no_exchange():
    """The exchange between ranks left out: each rank sorts its own shard."""
    return _swap(parallel, "distributed_radix_sort",
                 lambda f: lambda k, v, *a, **kw: (*glu.radix_sort(k, v), *_even_counts(k.shape[0], k.device)))


def altered():
    """An answer altered where it is produced: one element's low bit."""

    def sort_then_flip(f):
        def call(k, v, *a, **kw):
            out = f(k, v, *a, **kw)
            return (_flip_first(out[0]), *out[1:])

        return call

    return _all(
        _swap(glu, "radix_sort", sort_then_flip),
        _swap(glu, "exclusive_scan", lambda f: lambda x, *a, **kw: _flip_first(f(x, *a, **kw))),
        _swap(glu, "reduce", lambda f: lambda x, *a, **kw: _flip_first(f(x, *a, **kw))),
        _swap(parallel, "distributed_radix_sort", sort_then_flip))
