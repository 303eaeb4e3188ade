"""Writes dist/glu_tpu_torch_single.py, the port's single-file distribution.

    python -m glu_tpu_torch.amalgamate

The counterpart of generate.py, which flattens glu_tpu into one file. This
package does not survive flattening: its modules share names (each `_cuda_*`
module has its own TILE, `_lib` and launch counters), import each other as
objects (`from . import _cuda_sort as cs`), and find their CUDA sources in
csrc/ beside them. So the file keeps the modules apart: it carries each
module's source as a string under its dotted name and each kernel source
(csrc/*.cu, *.cuh) as a string under its file name, as the GL reference's
amalgamated headers carry their GLSL, and installs an import hook that runs
each module as `<file's module name>.<module>`, with every relative import
as written. `_build.kernel_sources()` reads the kernel sources from the
strings, and the kernels are built at first use into _build/ beside the
file. Any change under glu_tpu_torch/ is followed by a run of this module
and a commit of its output: tests/test_torch_dist_single.py fails on a
stale file.
"""

from __future__ import annotations

import pathlib

PKG = pathlib.Path(__file__).resolve().parent
TARGET = PKG.parent / "dist" / "glu_tpu_torch_single.py"

HEADER = '''# GENERATED by `python -m glu_tpu_torch.amalgamate` from glu_tpu_torch/: do not edit.
"""glu_tpu_torch in one file: copy it into a project and `import glu_tpu_torch_single as glu`.

It is the package glu_tpu_torch, the PyTorch/CUDA port of glu_tpu (every
name of glu_tpu_torch.__all__, and `glu.parallel`, `glu.entry`), and it
imports torch and nothing of the package it was made from. _MODULES holds
each module's source under its dotted name, _CUDA_SOURCES each CUDA kernel
source under its file name. On import the file makes itself a package and
installs an import hook that runs each module of _MODULES as a submodule of
this one, so each keeps its own globals and its relative imports. The
kernels are compiled at first use from _CUDA_SOURCES with nvcc (sm_90a)
into _build/ beside this file.
"""

import importlib.abc
import importlib.machinery
import linecache
import sys

'''

FOOTER = '''

class _Importer(importlib.abc.MetaPathFinder, importlib.abc.InspectLoader):
    """Finds the modules of _MODULES under this file's module name and runs
    them; a traceback shows their lines (linecache) under
    <this file>/glu_tpu_torch/<module path>."""

    def __init__(self, name: str):
        self.name = name

    def _source_name(self, fullname: str):
        if fullname == self.name or fullname.startswith(self.name + "."):
            source_name = "glu_tpu_torch" + fullname[len(self.name):]
            if source_name in _MODULES:
                return source_name
        return None

    def find_spec(self, fullname, path=None, target=None):
        if fullname == self.name or self._source_name(fullname) is None:
            return None
        return importlib.machinery.ModuleSpec(fullname, self, origin=__file__, is_package=self.is_package(fullname))

    def is_package(self, fullname: str) -> bool:
        source_name = self._source_name(fullname)
        return any(name.startswith(source_name + ".") for name in _MODULES)

    def get_source(self, fullname: str) -> str:
        return _MODULES[self._source_name(fullname)]

    def get_code(self, fullname: str):
        source = self.get_source(fullname)
        path = self._source_name(fullname).replace(".", "/") + ("/__init__.py" if self.is_package(fullname) else ".py")
        filename = f"{__file__}/{path}"
        linecache.cache[filename] = (len(source), None, source.splitlines(True), filename)
        return compile(source, filename, "exec", dont_inherit=True)

    def exec_module(self, module) -> None:
        module.__file__ = __file__
        exec(self.get_code(module.__name__), module.__dict__)


__path__ = []  # a package, whose submodules _Importer finds
if __spec__ is not None:
    __spec__.submodule_search_locations = __path__
__package__ = __name__
_importer = _Importer(__name__)
sys.meta_path.append(_importer)
exec(_importer.get_code(__name__), globals())  # the package's __init__
from . import entry, parallel  # noqa: E402
'''


def _literal(text: str) -> str:
    """A Python literal of text: a raw triple-quoted string where one can
    hold it, so that the file reads as the source; else repr."""
    if "'''" in text or text.endswith(("\\", "'")):
        return repr(text)
    return "r'''" + text + "'''"


def modules() -> dict[str, str]:
    """{dotted name: source} of every module of the package but this one, in
    name order."""
    out = {}
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG)
        if rel == pathlib.Path("amalgamate.py"):
            continue
        parts = ("glu_tpu_torch", *rel.with_suffix("").parts)
        out[".".join(parts[:-1] if parts[-1] == "__init__" else parts)] = path.read_bytes().decode()
    return dict(sorted(out.items()))


def render() -> str:
    """The text of the single file."""
    from . import _build

    def table(name: str, texts: dict) -> str:
        rows = "".join(f"    {key!r}: {_literal(text)},\n" for key, text in texts.items())
        return f"{name} = {{\n{rows}}}\n"

    return HEADER + table("_MODULES", modules()) + "\n" + table("_CUDA_SOURCES", _build.kernel_sources()) + FOOTER


def main() -> int:
    TARGET.parent.mkdir(exist_ok=True)
    TARGET.write_bytes(render().encode())
    print(f"wrote {TARGET} ({TARGET.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
