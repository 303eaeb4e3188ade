"""KB: the bucket stage of the distributed sort, a hand-written Hopper
streaming kernel (csrc/bucket.cu).

Counterpart of glu_tpu/parallel/dist_sort.py:94-110 (`_bucket_of`) and
:133-147 (`_bucket_of64`), which are not pallas_calls: they unroll the D - 1
splitter comparisons so that XLA fuses them into one elementwise pass over
the shard. Each element's destination rank is the count of splitters <=
(key, global index) in lexicographic order, keys compared unsigned; the
global index of element i is base + i (base = rank * n), an int64 here
(the JAX package's uint32 wraps above 2**32 global elements; below, the two
agree). One launch of `glu_bucket_of` / `glu_bucket_of64` reads the keys
once and writes the int32 ids once: no global-index array, no (D-1)
elementwise passes, no int64 key arrays.

Precondition: the splitters are in non-decreasing lexicographic order (key,
index), or (hi, lo, index), as dist_sort's `_sample_splitters` and
`_sample_splitters64` return them (quantile positions of one stable sort
whose gathered indices ascend). The kernel searches them (binary lifting,
ceil(log2 D) steps); on unsorted splitters it does not count them.

`bucket_of` and `bucket_of64` check their arguments, allocate with
torch.empty, launch on the current stream and count their launches; given
CPU tensors they run the plain versions `bucket_of_ref` and
`bucket_of64_ref`, which count splitter by splitter.
"""

from __future__ import annotations

import torch

from ..ops._common import kernels, launch, on_cuda
from ..ops.radix_sort import _SIGN
from ..utils.errors import check_argument
from ..utils.timing import start, stop

# Splitters staged in shared memory, fixed at compile time in csrc/bucket.cu
# (kSmemSplitters) and checked when the library is loaded; more are searched
# in global memory.
SMEM_SPLITTERS = 2048

# Launch count of KB (both forms), bumped only where it is launched.
bucket_launches = 0


def reset_launch_counts() -> None:
    global bucket_launches
    bucket_launches = 0


def launch_counts() -> dict:
    return {"bucket_of": bucket_launches}


def ordered(t: torch.Tensor) -> torch.Tensor:
    """int32 whose signed order is the u32 order of t's words."""
    return t.view(torch.int32) ^ _SIGN


def wide_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the u64 order of (hi, lo) u32 words."""
    return (ordered(hi).to(torch.int64) << 32) | (lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)


def _count_below(keys: torch.Tensor, base: int, s_keys: torch.Tensor, s_idx: torch.Tensor) -> torch.Tensor:
    """The count of splitters <= (key, base + i) for each key, keys and
    splitter keys in a form whose signed order is the key order; one
    elementwise pass a splitter, int32."""
    n = keys.shape[0]
    gidx = base + torch.arange(n, dtype=torch.int64, device=keys.device)
    bucket = torch.zeros(n, dtype=torch.int32, device=keys.device)
    for i in range(s_keys.shape[0]):
        bucket += (s_keys[i] < keys) | ((s_keys[i] == keys) & (s_idx[i] <= gidx))
    return bucket


def bucket_of_ref(words: torch.Tensor, base: int, s_words: torch.Tensor, s_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `bucket_of`, splitter by splitter (needs no order of
    the splitters)."""
    return _count_below(ordered(words), base, ordered(s_words), s_idx)


def bucket_of64_ref(hi, lo, base: int, s_hi, s_lo, s_idx) -> torch.Tensor:
    """Plain version of `bucket_of64`, on int64 keys built from the words."""
    return _count_below(wide_key(hi, lo), base, wide_key(s_hi, s_lo), s_idx)


def _check(words: list, base: int, s_words: list, s_idx: torch.Tensor) -> None:
    first = words[0]
    for name, ts, dtype in (("keys", words, torch.uint32), ("splitter keys", s_words, torch.uint32),
                            ("splitter indices", [s_idx], torch.int64)):
        for t in ts:
            check_argument(t.dtype == dtype, "%s must be %s, got %s", name, dtype, t.dtype)
            check_argument(t.dim() == 1 and t.is_contiguous(), "%s must be 1-D and contiguous", name)
            check_argument(t.device == first.device, "keys on %s, %s on %s", first.device, name, t.device)
    check_argument(all(w.shape == first.shape for w in words), "key word length mismatch")
    check_argument(all(s.shape == s_idx.shape for s in s_words), "splitter length mismatch")
    check_argument(s_idx.shape[0] < 2**31, "too many splitters: %d", s_idx.shape[0])
    check_argument(0 <= int(base) <= 2**63 - 1 - first.shape[0], "base %s out of range", base)


def _launch(fn_name: str, words: list, base: int, s_words: list, s_idx: torch.Tensor) -> torch.Tensor:
    global bucket_launches
    n = words[0].shape[0]
    out = torch.empty(n, dtype=torch.int32, device=words[0].device)
    if n == 0:
        return out
    lib = kernels(bucket_smem_splitters=SMEM_SPLITTERS)
    launch(lib, fn_name, out.device, *(w.data_ptr() for w in words), n, int(base),
           *(s.data_ptr() for s in s_words), s_idx.data_ptr(), s_idx.shape[0], out.data_ptr())
    bucket_launches += 1
    return out


def bucket_of(words: torch.Tensor, base: int, s_words: torch.Tensor, s_idx: torch.Tensor) -> torch.Tensor:
    """KB (replaces dist_sort.py::_bucket_of): for each of the n u32 keys
    `words`, the count of the D - 1 splitters (s_words[j] u32, s_idx[j]
    int64), in non-decreasing lexicographic order, that are <= (words[i],
    base + i). Returns n int32, in one launch on a CUDA tensor."""
    opened = start("glu.engine.kb")
    try:
        _check([words], base, [s_words], s_idx)
        if not on_cuda(words):
            return bucket_of_ref(words, base, s_words, s_idx)
        return _launch("glu_bucket_of", [words], base, [s_words], s_idx)
    finally:
        stop(opened)


def bucket_of64(hi: torch.Tensor, lo: torch.Tensor, base: int, s_hi: torch.Tensor, s_lo: torch.Tensor,
                s_idx: torch.Tensor) -> torch.Tensor:
    """KB's 64-bit form (replaces dist_sort.py::_bucket_of64): the same count
    under lexicographic (hi, lo, global index) order, keys given as u32
    words."""
    opened = start("glu.engine.kb")
    try:
        _check([hi, lo], base, [s_hi, s_lo], s_idx)
        if not on_cuda(hi):
            return bucket_of64_ref(hi, lo, base, s_hi, s_lo, s_idx)
        return _launch("glu_bucket_of64", [hi, lo], base, [s_hi, s_lo], s_idx)
    finally:
        stop(opened)