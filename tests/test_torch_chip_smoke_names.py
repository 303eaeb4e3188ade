"""The names of the port that chip_smoke.py reads exist.

chip_smoke.py is the card check: it runs only where there is a card, so a
rename or a deletion in the port that it still reads would show nowhere on
the CPU. This test parses its source, finds each alias it binds to a module
of glu_tpu_torch (`from glu_tpu_torch.ops import _cuda_sort as cs`, ...)
and every `alias.name` it reads or writes, and checks that each name exists
on that module. Nothing of chip_smoke.py is run."""

import ast
import importlib
from pathlib import Path

import pytest

SOURCE = Path(__file__).resolve().parent.parent / "chip_smoke.py"

ALIASES = {  # the alias chip_smoke.py binds -> the module it binds it to
    "glu": "glu_tpu_torch",
    "glu_tpu_torch": "glu_tpu_torch",
    "cs": "glu_tpu_torch.ops._cuda_sort",
    "cr": "glu_tpu_torch.ops._cuda_reduce",
    "csc": "glu_tpu_torch.ops._cuda_scan",
    "cb": "glu_tpu_torch.parallel._cuda_bucket",
    "ds": "glu_tpu_torch.parallel.dist_sort",
    "router": "glu_tpu_torch.ops.router",
    "parallel": "glu_tpu_torch.parallel",
    "_build": "glu_tpu_torch._build",
}


def _tree() -> ast.Module:
    return ast.parse(SOURCE.read_text(), filename=str(SOURCE))


def _module_aliases(tree: ast.Module) -> dict:
    """alias -> the set of glu_tpu_torch modules chip_smoke.py binds it to."""
    bound: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "glu_tpu_torch":  # `import a.b` binds a, `import a.b as c` binds a.b
                    bound.setdefault(a.asname or "glu_tpu_torch", set()).add(a.name if a.asname else "glu_tpu_torch")
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").split(".")[0] == "glu_tpu_torch":
            for a in node.names:
                full = f"{node.module}.{a.name}"
                try:
                    importlib.import_module(full)
                except ImportError:
                    continue  # a function or class, not a module
                bound.setdefault(a.asname or a.name, set()).add(full)
    return bound


def _reads(tree: ast.Module, alias: str) -> set:
    return {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == alias}


def test_chip_smoke_binds_these_module_aliases_and_no_others():
    assert _module_aliases(_tree()) == {alias: {module} for alias, module in ALIASES.items()}


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_every_name_chip_smoke_reads_exists(alias):
    module = importlib.import_module(ALIASES[alias])
    names = _reads(_tree(), alias)
    assert names, f"chip_smoke.py reads nothing through {alias}"
    missing = sorted(n for n in names if not hasattr(module, n))
    assert not missing, f"chip_smoke.py reads {alias}.{missing} ({ALIASES[alias]})"
