"""Integer math helpers.

Counterpart of glu_tpu/utils/math.py, itself the analog of reference
glu/gl_utils.hpp:267-302 (div_ceil,
is_power_of_2, next_power_of_2, log32_floor/ceil). Python ints are unbounded
so the bit-smearing implementation of next_power_of_2 is replaced with
bit_length arithmetic; semantics match the reference for all uint64 inputs.
"""

from __future__ import annotations


def div_ceil(num: int, den: int) -> int:
    """Ceiling division (reference gl_utils.hpp:286-289)."""
    return -(-num // den)


def is_power_of_2(n: int) -> bool:
    """True for 1, 2, 4, ... (reference gl_utils.hpp:291-294)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_2(n: int) -> int:
    """Smallest power of two >= n (reference gl_utils.hpp:296-302)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def log2_floor(n: int) -> int:
    """floor(log2(n)) for n >= 1."""
    if n < 1:
        raise ValueError("log2_floor requires n >= 1")
    return n.bit_length() - 1


def log2_ceil(n: int) -> int:
    """ceil(log2(n)) for n >= 1."""
    if n < 1:
        raise ValueError("log2_ceil requires n >= 1")
    return (n - 1).bit_length()


def log32_floor(n: int) -> int:
    """floor(log32(n)) — depth of a radix-32 reduction tree (reference gl_utils.hpp:267-277)."""
    return log2_floor(n) // 5


def log32_ceil(n: int) -> int:
    """ceil(log32(n)) (reference gl_utils.hpp:279-284)."""
    return div_ceil(log2_ceil(n), 5)
