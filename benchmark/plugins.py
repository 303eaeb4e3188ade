"""Finds the benchmark's parts by name: `<folder>/<name>.py` under
benchmark/ (ops/, dists/, metrics/), loaded by its path, since names may
hold dots and dashes. A later cell, traffic mix or metric adds a file; no
file here lists them."""

from __future__ import annotations

import importlib.util
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parent
_loaded: dict = {}


def path(folder: str, name: str) -> pathlib.Path:
    return BENCH / folder / f"{name}.py"


def load(folder: str, name: str):
    """The module `<folder>/<name>.py`, loaded once a process."""
    key = (folder, name)
    if key not in _loaded:
        file = path(folder, name)
        if not file.is_file():
            raise KeyError(f"no {folder}/{name}.py under {BENCH}")
        spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[key] = module
    return _loaded[key]
