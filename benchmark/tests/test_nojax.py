"""Nothing the benchmark runs has the top-level name jax, jaxlib, flax or
glu_tpu, compared whole (glu_tpu_torch is the port): by the imports in
every source under benchmark/, and by sys.modules after a CPU run of every
one-card cell in a fresh interpreter."""

import ast
import json
import subprocess
import sys

from benchmark import harness


def _imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_a_forbidden_module():
    sources = sorted(harness.BENCH.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        assert not _imported(path) & set(harness.FORBIDDEN), path
    assert all("glu_tpu_torch" in _imported(path) for path in harness.BENCH.glob("ops/*.py"))  # the scan sees them


def test_whole_names_are_compared(monkeypatch):
    import glu_tpu_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "glu_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "glu_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["glu_tpu", "jax"]


def test_no_forbidden_module_after_a_cpu_run():
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests import cells\nfrom benchmark import harness\n"
            "for name in ('u32_2p28_1card.sort_uniform', 'u32_small_1card.sort_closed', 'u32_2p28_1card.scan_reduce'):\n"
            "    assert cells.run(name)['correct']\n"
            "print(json.dumps(harness.forbidden_modules()))\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
