"""Verbose logging gate (counterpart of glu_tpu/utils/log.py).

GLU_TPU_VERBOSE=1 sends diagnostics to stderr: tile counts, pass layout.
"""

from __future__ import annotations

import os
import sys


def verbose_enabled() -> bool:
    return os.environ.get("GLU_TPU_VERBOSE", "0") == "1"


def vlog(fmt: str, *args) -> None:
    """Print a diagnostic line to stderr when GLU_TPU_VERBOSE=1."""
    if verbose_enabled():
        print("glu_tpu_torch: " + (fmt % args if args else fmt), file=sys.stderr)
