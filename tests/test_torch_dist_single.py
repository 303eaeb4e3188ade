"""The port's single-file distribution (dist/glu_tpu_torch_single.py, written
by `python -m glu_tpu_torch.amalgamate`) against the package it is made from.

The file is generated afresh from a copy of the package in a temporary
directory, so the committed file is never overwritten: the committed one
must equal it byte for byte (the drift guard), and the tests import the
fresh one. It must import in a process of its own without glu_tpu_torch,
glu_tpu or jax; expose the package's whole surface; keep each module's own
globals (each `_cuda_*` module's TILE and launch counters); carry the CUDA
sources byte for byte under the package's library name; build from them
(nvcc is faked here: the CPU has none) and raise when the build fails; and
give the package's results (integers bit for bit, floats within rtol 1e-4,
atol 1e-3 as tests/test_reduce.py:63) and glu_tpu's.
"""

import hashlib
import importlib
import os
import pathlib
import shutil
import subprocess
import sys
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glu_tpu
import glu_tpu_torch
import glu_tpu_torch.parallel
from glu_tpu_torch import _build, from_numpy, to_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAME = "glu_tpu_torch_single"
FLOAT_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def single_path(tmp_path_factory):
    work = tmp_path_factory.mktemp("amalgam")
    shutil.copytree(ROOT / "glu_tpu_torch", work / "glu_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    subprocess.run([sys.executable, "-m", "glu_tpu_torch.amalgamate"], check=True, cwd=work,
                   capture_output=True, timeout=120)
    return work / "dist" / f"{NAME}.py"


@pytest.fixture(scope="module")
def single(single_path):
    sys.path.insert(0, str(single_path.parent))
    try:
        import glu_tpu_torch_single
        import glu_tpu_torch_single._build  # noqa: F401  (imported at the first build)

        yield glu_tpu_torch_single
    finally:
        sys.path.remove(str(single_path.parent))


def test_committed_file_matches_a_fresh_generation(single_path):
    """Drift guard: a change under glu_tpu_torch/ without a run of
    `python -m glu_tpu_torch.amalgamate` (and a commit of dist/) fails here."""
    committed = (ROOT / "dist" / f"{NAME}.py").read_bytes()
    assert committed == single_path.read_bytes(), (
        f"dist/{NAME}.py is stale: run `python -m glu_tpu_torch.amalgamate` and commit the result")


def test_imports_alone(single_path, tmp_path):
    """In a fresh process, from a directory without the package: the file
    imports, sorts, and imports none of glu_tpu_torch, glu_tpu and jax."""
    code = (f"import sys; sys.path.insert(0, {str(single_path.parent)!r}); import torch; import {NAME} as g; "
            "k = torch.arange(100, 0, -1, dtype=torch.int32).view(torch.uint32); "
            "assert g.radix_sort(k, k)[0].view(torch.int32).tolist() == list(range(1, 101)); "
            "print(sorted(m for m in ('glu_tpu_torch', 'glu_tpu', 'jax') if m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_has_the_whole_surface(single):
    for name in glu_tpu_torch.__all__:
        assert getattr(single, name).__module__.startswith(NAME), name
    for name in glu_tpu_torch.parallel.__all__:
        assert getattr(single.parallel, name).__module__.startswith(f"{NAME}.parallel"), name
    assert callable(single.entry.entry) and callable(single.entry.dryrun_multichip)
    assert single.__file__ == sys.modules[f"{NAME}.ops.radix_sort"].__file__ == str(single.__spec__.origin)


@pytest.mark.parametrize("module, tile", [("_cuda_sort", 6144), ("_cuda_scan", 8192), ("_cuda_reduce", 4096)])
def test_each_module_keeps_its_own_state(single, monkeypatch, module, tile):
    mine, theirs = (importlib.import_module(f"{pkg}.ops.{module}") for pkg in (NAME, "glu_tpu_torch"))
    assert mine.TILE == theirs.TILE == tile
    assert mine is not theirs
    before = theirs.launch_counts()
    for name in vars(mine):
        if name.endswith("_launches"):
            monkeypatch.setattr(mine, name, 7)
    assert set(mine.launch_counts().values()) == {7}
    assert theirs.launch_counts() == before


def test_carries_the_kernel_sources(single):
    files = {f.name: f.read_bytes().decode() for f in sorted(_build._CSRC.glob("*.cu*"))}
    assert set(files) == {"fold.cuh", "lookback.cuh", "radix_sort.cu", "reduce.cu", "scan.cu"}
    assert single._CUDA_SOURCES == files == _build.kernel_sources() == single._build.kernel_sources()
    assert not single._build._CSRC.exists()  # the single file reads no csrc/ directory


def test_library_name_is_the_hash_of_flags_and_sources(single, single_path):
    """The name the package's library had before the sources became texts
    (the flags, then each file's name and bytes, in name order), for the
    package and for the single file, whose library goes to _build/ beside it."""
    h = hashlib.sha256(" ".join(_build._FLAGS).encode())
    for f in sorted(_build._CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    name = f"libglu_kernels_{h.hexdigest()[:16]}.so"
    assert _build._library_path() == _build._PKG / "_build" / name
    assert single._build._library_path() == single_path.parent / "_build" / name


@pytest.mark.parametrize("which", ["package", "single"])
@pytest.mark.parametrize("nvcc_fails", [False, True])
def test_build_compiles_the_staged_sources(single, monkeypatch, tmp_path, which, nvcc_fails):
    """build() writes every source into one staging directory, compiles each
    .cu there (their #include lines resolve beside them), links, and removes
    the staging directory; a failing nvcc raises with its output."""
    build = _build if which == "package" else single._build
    monkeypatch.setattr(build, "_BUILD", tmp_path)
    seen = []

    def fake_run_all(cmds):
        for cmd in cmds:
            at = cmd.index("-o")
            inputs = [pathlib.Path(a) for a in cmd[at + 2:]]
            seen.append(([p.name for p in inputs],
                         {f.name: f.read_bytes().decode() for f in inputs[0].parent.glob("*.cu*")}))
            pathlib.Path(cmd[at + 1]).write_bytes(b"")
        return [(1 if nvcc_fails else 0, "nvcc: error: boom\n")] * len(cmds)

    monkeypatch.setattr(build, "run_all", fake_run_all)
    if nvcc_fails:
        with pytest.raises(build.GluError, match="boom"):
            build.build()
        compiles, left = seen, []
    else:
        so, _, log = build.build()
        assert so == build._library_path() and "boom" in log
        assert seen[-1][0] == ["radix_sort.o", "reduce.o", "scan.o"]  # the link
        compiles, left = seen[:-1], sorted([so.name, so.with_suffix(".log").name])
    assert [inputs for inputs, _ in compiles] == [["radix_sort.cu"], ["reduce.cu"], ["scan.cu"]]
    assert all(staged == _build.kernel_sources() for _, staged in compiles)
    assert sorted(p.name for p in tmp_path.iterdir()) == left


def test_build_without_nvcc_raises(single, monkeypatch, tmp_path):
    monkeypatch.setattr(single._build, "_BUILD", tmp_path)
    monkeypatch.setattr(single._build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(single.GluError, match="cannot run nvcc"):
        single._build.load_library()
    assert single._build._lib is None and list(tmp_path.iterdir()) == []


def test_tracebacks_show_the_module_lines(single):
    with pytest.raises(single.GluError) as info:
        single.ops.backend.resolve_backend("nope", torch.zeros(1))
    text = "".join(traceback.format_exception(info.value))
    assert f"{NAME}.py/glu_tpu_torch/ops/backend.py" in text
    assert "check_argument(backend in _VALID" in text


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _cases():
    """name: (call on a module, arguments as numpy arrays)."""
    rng = np.random.default_rng(2026)
    n = 30_000  # above the single-tile limit: the onesweep path's plain versions
    keys, vals = _u32(rng, n), np.arange(n, dtype=np.uint32)
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[rng.integers(0, n, 60)] = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf], np.float32).repeat(10)
    u64 = (_u32(rng, n).astype(np.uint64) << np.uint64(32)) | _u32(rng, n)
    u64[::3] = u64[1::3][: len(u64[::3])]  # duplicates
    offsets = np.concatenate([[0], np.sort(rng.integers(0, n, 9)), [n]]).astype(np.int32)
    offsets[4] = offsets[5]  # an empty segment
    small = rng.integers(0, 1000, n).astype(np.uint32)
    floats = rng.standard_normal(n).astype(np.float32)
    sum_op = lambda g: g.ReduceOperator.SUM  # noqa: E731
    return {
        "radix_sort cuda": (lambda g, k, v: g.radix_sort(k, v, backend="cuda"), (keys, vals)),
        "radix_sort torch": (lambda g, k, v: g.radix_sort(k, v, backend="torch"), (keys, vals)),
        "radix_sort_f32 specials": (lambda g, k, v: g.radix_sort_f32(k, v, backend="cuda"), (f32, vals)),
        "radix_sort_u64 duplicates": (lambda g, k, v: g.radix_sort_u64(k, v, backend="cuda"), (u64, vals)),
        "radix_sort_segmented offsets": (
            lambda g, k, v, o: g.radix_sort_segmented(k, v, offsets=o, backend="cuda"), (keys, vals, offsets)),
        "exclusive_scan offsets u32": (lambda g, x, o: g.exclusive_scan(x, offsets=o, backend="cuda"), (small, offsets)),
        "inclusive_scan offsets f32": (lambda g, x, o: g.inclusive_scan(x, offsets=o, backend="cuda"), (floats, offsets)),
        "exclusive_scan f32": (lambda g, x: g.exclusive_scan(x, backend="cuda"), (floats,)),
        "segmented_reduce offsets": (lambda g, x, o: g.segmented_reduce(x, o, sum_op(g), backend="cuda"), (small, offsets)),
        "reduce u32 SUM": (lambda g, x: g.reduce(x, sum_op(g), backend="cuda"), (keys,)),
        "reduce f32 MAX": (lambda g, x: g.reduce(x, g.ReduceOperator.MAX, backend="cuda"), (floats,)),
    }


CASES = _cases()


def _as_numpy(out):
    return [to_numpy(t) for t in ((out,) if isinstance(out, torch.Tensor) else out)]


@pytest.mark.parametrize("case", list(CASES))
def test_results_match_the_package(single, case):
    call, args = CASES[case]
    got = _as_numpy(call(single, *(from_numpy(a, "cpu") for a in args)))
    want = _as_numpy(call(glu_tpu_torch, *(from_numpy(a, "cpu") for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.kind == "f" and "sort" not in case:
            np.testing.assert_allclose(g, w, **FLOAT_TOL)
        else:  # integers, and sorted floats as bit patterns (-0.0, NaNs)
            np.testing.assert_array_equal(g.view(f"u{g.itemsize}"), w.view(f"u{w.itemsize}"))


def test_sort_matches_glu_tpu(single):
    keys, vals = CASES["radix_sort cuda"][1]
    want_k, want_v = glu_tpu.radix_sort(jnp.asarray(keys), jnp.asarray(vals), backend="xla")
    for backend in ("cuda", "torch"):
        got_k, got_v = single.radix_sort(from_numpy(keys, "cpu"), from_numpy(vals, "cpu"), backend=backend)
        np.testing.assert_array_equal(to_numpy(got_k), np.asarray(want_k))
        np.testing.assert_array_equal(to_numpy(got_v), np.asarray(want_v))
