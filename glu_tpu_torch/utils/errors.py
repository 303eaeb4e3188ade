"""Fail-fast error checks.

Counterpart of glu_tpu/utils/errors.py (reference glu/errors.hpp:8-18:
GLU_CHECK_STATE, GLU_CHECK_ARGUMENT, GLU_FAIL): the library raises typed
exceptions instead of exiting the process.
"""

from __future__ import annotations


class GluError(RuntimeError):
    """Base error for glu_tpu_torch precondition violations."""


class GluStateError(GluError):
    """An internal state invariant was violated (analog of GLU_CHECK_STATE)."""


class GluArgumentError(GluError, ValueError):
    """A user-supplied argument was invalid (analog of GLU_CHECK_ARGUMENT)."""


def fail(fmt: str, *args) -> None:
    """Unconditional failure (analog of GLU_FAIL, reference glu/errors.hpp:17)."""
    raise GluError(fmt % args if args else fmt)


def check_state(cond: bool, fmt: str = "state check failed", *args) -> None:
    """Analog of GLU_CHECK_STATE (reference glu/errors.hpp:8-11)."""
    if not cond:
        raise GluStateError(fmt % args if args else fmt)


def check_argument(cond: bool, fmt: str = "invalid argument", *args) -> None:
    """Analog of GLU_CHECK_ARGUMENT (reference glu/errors.hpp:12-15)."""
    if not cond:
        raise GluArgumentError(fmt % args if args else fmt)
