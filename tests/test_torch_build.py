"""The port's build helpers (glu_tpu_torch/_build.py) and the design-variant
tool built on them (tools/onesweep_variants.py), on the CPU: no nvcc is run.
The tool's variants replace exact lines of the kernel sources, so each must
still apply to the sources as they stand."""

import importlib.util
import pathlib
import re
import types

import pytest

from glu_tpu_torch import _build

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("onesweep_variants", ROOT / "tools" / "onesweep_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)


@pytest.mark.parametrize("name", list(variants.VARIANTS))
def test_variant_edits_apply(name):
    texts = variants.variant_sources(name)
    sources = {f.name: f.read_text() for f in _build._CSRC.glob("*.cu*")}
    assert set(texts) == set(sources)
    changed = {file for file in texts if texts[file] != sources[file]}
    assert changed == {file for file, _, _ in variants.VARIANTS[name]}


def test_variant_edit_that_misses_raises(monkeypatch):
    monkeypatch.setitem(variants.VARIANTS, "missing", [("radix_sort.cu", "no such line;", "")])
    with pytest.raises(ValueError, match="not found exactly once"):
        variants.variant_sources("missing")


@pytest.mark.parametrize("shared", [False, True])
def test_nvcc_command(shared):
    srcs = [pathlib.Path("a.cu"), pathlib.Path("b.cu")]
    cmd = _build.nvcc_command(srcs, pathlib.Path("out.o"), shared=shared)
    assert cmd[1:1 + len(_build._FLAGS)] == _build._FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-5:] == ["-shared" if shared else "-c", "-o", "out.o", "a.cu", "b.cu"]


def test_bind_signatures_covers_every_entry_point():
    """Every extern "C" function of the kernel sources gets a return type."""
    entries = set()
    for src in _build._CSRC.glob("*.cu"):
        entries |= set(re.findall(r"^(?:int|const char\*) (glu_\w+)\(", src.read_text(), re.M))
    assert {"glu_digit_histograms", "glu_onesweep_pass", "glu_scan_pass", "glu_reduce"} <= entries

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build.bind_signatures(FakeLib())
    assert {name for name in vars(lib) if hasattr(getattr(lib, name), "restype")} == entries
