"""The port's utility layer (glu_tpu_torch.utils) against glu_tpu.utils: the
same inputs through both packages, exact results."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import glu_tpu.utils as jutils
import glu_tpu_torch.utils as tutils
from glu_tpu_torch.utils import DataType, DeviceBuffer, copy_buffer, from_numpy, to_numpy

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "name", ["div_ceil", "is_power_of_2", "next_power_of_2", "log2_floor", "log2_ceil",
             "log32_floor", "log32_ceil"],
)
def test_math_parity(name):
    # semantics of reference gl_utils.hpp:267-302, in both packages
    jf, tf = getattr(jutils, name), getattr(tutils, name)
    for n in [1, 2, 3, 5, 31, 32, 33, 1023, 1024, 1025, 2**31 - 1, 2**32, 2**40 + 7]:
        if name == "div_ceil":
            for d in (1, 3, 32, 1000):
                assert tf(n, d) == jf(n, d)
        else:
            assert tf(n) == jf(n)


@pytest.mark.parametrize("fn", ["check_argument", "check_state", "fail"])
def test_errors_parity(fn):
    # the same failure raises the counterpart class with the same message
    jerr, terr = jutils.errors, tutils.errors
    args = ("bad %d of %s", 42, "x")
    pairs = {
        "check_argument": (jerr.GluArgumentError, terr.GluArgumentError),
        "check_state": (jerr.GluStateError, terr.GluStateError),
        "fail": (jerr.GluError, terr.GluError),
    }
    jcls, tcls = pairs[fn]
    call = (lambda m: getattr(m, fn)(*args)) if fn == "fail" else (lambda m: getattr(m, fn)(False, *args))
    with pytest.raises(jcls) as je:
        call(jerr)
    with pytest.raises(tcls) as te:
        call(terr)
    assert str(te.value) == str(je.value) == "bad 42 of x"
    assert issubclass(tcls, terr.GluError)
    if fn != "fail":
        getattr(terr, fn)(True, *args)  # a holding condition raises nothing


def test_dtype_map_all_12():
    # the 12 GLU element types (reference data_types.hpp:8-22), mapped to the
    # torch dtype whose numpy form is the JAX package's dtype
    for dt in DataType:
        jinfo = jutils.dtype_info(getattr(jutils.DataType, dt.name))
        tinfo = tutils.dtype_info(dt)
        assert tinfo.name == jinfo.name
        assert tinfo.components == jinfo.components
        assert tinfo.element_shape() == jinfo.element_shape()
        assert tinfo.itemsize == jinfo.itemsize
        assert torch.empty(0, dtype=tinfo.dtype).numpy().dtype == np.dtype(jinfo.dtype)
    assert tutils.to_torch_dtype(DataType.UINT) == torch.uint32
    assert tutils.to_torch_dtype(DataType.DVEC4) == torch.float64  # f64 is fine on the GPU


def test_u32_round_trip():
    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)
    t = from_numpy(a, "cpu")
    assert t.dtype == torch.uint32 and t.shape == (6,)
    back = to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, a)
    # int32 bit patterns, the port's internal carrier
    np.testing.assert_array_equal(t.view(torch.int32).numpy(), a.view(np.int32))
    a[0] = 9  # a copy, not a view of the caller's array
    assert int(to_numpy(t)[0]) == 0


def test_device_buffer_parity():
    # surface of reference ShaderStorageBuffer (gl_utils.hpp:146-246): the
    # same calls on both packages' buffers leave the same contents
    jbuf = jutils.DeviceBuffer(size=8)
    tbuf = DeviceBuffer(size=8, device="cpu")
    assert tbuf.dtype == torch.uint32 and tbuf.size == jbuf.size == 8
    steps = [
        lambda b: b.write_data(np.arange(8, dtype=np.uint32) + 0xFFFFFFF0),
        lambda b: b.resize(16, keep_data=True),
        lambda b: b.write_data(np.array([5, 6, 7], dtype=np.uint32)),
        lambda b: b.clear(0xFFFFFFFF),
        lambda b: b.write_data(np.array([1, 2], dtype=np.uint32)),
        lambda b: b.resize(4, keep_data=True),
        lambda b: b.resize(6, keep_data=False),
    ]
    for step in steps:
        step(jbuf)
        step(tbuf)
        np.testing.assert_array_equal(tbuf.get_data(), jbuf.get_data())
        assert tbuf.get_data().dtype == np.uint32
    np.testing.assert_array_equal(tbuf.get_data(3), jbuf.get_data(3))
    with pytest.raises(tutils.GluError):
        tbuf.write_data(np.zeros(7, np.uint32))


def test_copy_buffer_parity():
    import jax.numpy as jnp

    src = np.arange(5, dtype=np.uint32) + 0x80000000
    for size in (None, 3, 5, 7):
        want = np.asarray(jutils.copy_buffer(jnp.asarray(src), size))
        t = from_numpy(src, "cpu")
        got = copy_buffer(t, size)
        np.testing.assert_array_equal(to_numpy(got), want)
        assert got.data_ptr() != t.data_ptr()


def test_timing_cpu():
    from glu_tpu_torch.utils.timing import StopWatch, measure_elapsed_time, ns_to_human_string

    ns, result = measure_elapsed_time(lambda: torch.arange(10).sum())
    assert ns > 0 and int(result) == 45
    for v in (1.5e9, 2.5e6, 3.25e3, 500):
        assert ns_to_human_string(v) == jutils.timing.ns_to_human_string(v)
    assert StopWatch().elapsed_ns() >= 0


def test_import_has_no_jax():
    # a fresh interpreter: this test process has already imported jax
    code = (
        "import sys, glu_tpu_torch, glu_tpu_torch.ops._cuda_sort, glu_tpu_torch.ops._cuda_scan,"
        " glu_tpu_torch.ops._cuda_reduce; sys.exit('jax' in sys.modules or 'glu_tpu' in sys.modules)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_the_card():
    # a tensor made without a device goes to the card, and without a card
    # the call raises: it never falls back to the CPU
    a = np.arange(4, dtype=np.uint32)
    calls = [
        lambda: from_numpy(a),
        lambda: DeviceBuffer(a).data,
        lambda: DeviceBuffer(size=4).data,
        lambda: tutils.default_device(),
    ]
    for call in calls:
        if torch.cuda.is_available():
            got = call()
            assert (got.type if isinstance(got, torch.device) else got.device.type) == "cuda"
        else:
            with pytest.raises(tutils.GluError, match="no CUDA device"):
                call()
    if not torch.cuda.is_available():
        from glu_tpu_torch import RadixSort

        with pytest.raises(tutils.GluError, match="no CUDA device"):
            RadixSort().prepare_internal_buffers(16)
    # a tensor given to DeviceBuffer keeps its device; "cpu" is asked for
    assert DeviceBuffer(torch.zeros(3, dtype=torch.int32)).device.type == "cpu"
    assert tutils.default_device("cpu") == torch.device("cpu")


def test_debug_printers_parity():
    import io

    import jax.numpy as jnp

    from glu_tpu.utils import debug as jdebug
    from glu_tpu_torch.utils import debug as tdebug

    data = np.array([0, 7, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    for printer in ("print_buffer", "print_buffer_hex"):
        for count in (None, 2):
            jout, tout = io.StringIO(), io.StringIO()
            getattr(jdebug, printer)(jnp.asarray(data), count, name="k", file=jout)
            getattr(tdebug, printer)(DeviceBuffer(data, device="cpu"), count, name="k", file=tout)
            assert tout.getvalue() == jout.getvalue()


def test_trace_writes_chrome_trace(tmp_path):
    from glu_tpu_torch.utils.timing import trace

    with trace(str(tmp_path)) as prof:
        torch.arange(100).sum()
    assert prof is not None
    assert (tmp_path / "trace.json").stat().st_size > 0
