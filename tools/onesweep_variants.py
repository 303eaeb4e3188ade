#!/usr/bin/env python3
"""Times design variants of the sort's and the scan's kernels on one NVIDIA GPU.

    python3 tools/onesweep_variants.py          # from the root of the repository
    python3 tools/onesweep_variants.py --baseline DIR   # also DIR's glu_tpu_torch/csrc as it stands

Each variant is the kernel library, glu_tpu_torch/csrc, as it stands, with a
few lines of radix_sort.cu, lookback.cuh or scan.cu replaced: another
occupancy, another chunk of the pass's stores, another tile shape, another
ranker, other memory orders on the status words, the payloads loaded later,
two diagnostics that drop a step (their output is wrong; they bound that
step's cost), and other tiles of the single-pass scan (K4). Every variant
is built with nvcc into glu_tpu_torch/_build/variants/ (listed in
.gitignore), one nvcc per variant, all at once, and timed with CUDA events
on 2^28 u32 words: one 8-bit onesweep pass of 2 streams (key, value) and of
3 (key and two values), and one exclusive scan of the keys (the status
words' zeroing is timed alone and subtracted from each), and
digit_histograms over 4 passes of 8 bits; every library in turns, so that
a drift of the card's clocks falls on each alike. Each variant's output is
checked against the plain torch versions. --baseline DIR adds one more library,
built from DIR/glu_tpu_torch/csrc unedited (say, a git archive of another
commit), timed the same way. The card's name and power limit come first;
one line per library follows, with ptxas's registers and spills of the
onesweep kernel and of the u32 SUM scan, and how many CTAs of a 2- and a
3-stream pass an SM holds (where the library can say). Needs a CUDA device
and nvcc; writes nothing else.

The edits name exact text of the sources, so an edit of those lines breaks
a variant: tests/test_torch_build.py checks on the CPU that every
variant still applies. The libraries are built by glu_tpu_torch's own
_build (nvcc_command, run_all); the tool binds the few entries it calls,
which every commit's library has.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "glu_tpu_torch" / "csrc"
OUT = ROOT / "glu_tpu_torch" / "_build" / "variants"
N = 1 << 28
REPS = 9

# name: [(file, text in the source, replacement), ...]
VARIANTS = {
    "as built": [],
    "3 CTAs an SM (56 registers: ranks 4 rows and stores 4 ranks at a time)": [
        ("radix_sort.cu", "constexpr int kTileCtasPerSm = 2;", "constexpr int kTileCtasPerSm = 3;"),
        ("radix_sort.cu", "constexpr int kStoreItems = 8;", "constexpr int kStoreItems = 4;"),
        ("radix_sort.cu",
         "  rank_rows(dig, digit.nbits, runs,\n"
         "            [&](int j, int rank) { source[rank] = static_cast<uint16_t>(first + 32 * j + lane); });\n",
         "  for (int c = 0; c < kTileItems; c += 4) {\n"
         "    const uint32_t rows[4] = {dig[c], dig[c + 1], dig[c + 2], dig[c + 3]};\n"
         "    rank_rows(rows, digit.nbits, runs,\n"
         "              [&](int j, int rank) { source[rank] = static_cast<uint16_t>(first + 32 * (c + j) + lane); });\n"
         "  }\n"),
    ],
    "stores 16 ranks at a time (every rank of a thread at once)": [
        ("radix_sort.cu", "constexpr int kStoreItems = 8;", "constexpr int kStoreItems = 16;"),
    ],
    "tile 4096 (256 threads x 16, 3 CTAs/SM)": [
        ("radix_sort.cu", "constexpr int kTileThreads = 384;", "constexpr int kTileThreads = 256;"),
        ("radix_sort.cu", "constexpr int kTileCtasPerSm = 2;", "constexpr int kTileCtasPerSm = 3;"),
    ],
    "tile 8192 (512 threads x 16, 2 CTAs/SM)": [  # up to 5 payloads: 6 streams' tiles fill a CTA's shared memory
        ("radix_sort.cu", "constexpr int kMaxStreams = 8;", "constexpr int kMaxStreams = 6;"),
        ("radix_sort.cu", "constexpr int kTileThreads = 384;", "constexpr int kTileThreads = 512;"),
    ],
    "ranker: __match_any_sync": [
        ("radix_sort.cu", "peers[j] = match_digit(dig[j], nbits);",
         "peers[j] = __match_any_sync(0xffffffffu, dig[j]) & (dig[j] < kMaxBins ? ~0u : 0u);"),
    ],
    "status words: release stores, acquire loads": [
        ("lookback.cuh", "st.relaxed.gpu.global.u64", "st.release.gpu.global.u64"),
        ("lookback.cuh", "ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
    ],
    "payloads: plain loads after the look-back": [
        ("radix_sort.cu", "  for (int st = 1; st < s.count; ++st) stage_tile_async(s_in[st] + base, stage + st * kTile, tile_n);\n", ""),
        ("radix_sort.cu", "  cp_async_wait<0>();\n  __syncthreads();\n\n  // (d)",
         "  for (int st = 1; st < s.count; ++st)\n"
         "    for (int i = t; i < tile_n; i += kTileThreads) stage[st * kTile + i] = s_in[st][base + i];\n"
         "  __syncthreads();\n\n  // (d)"),
    ],
    "diagnostic: no look-back (wrong output)": [
        ("radix_sort.cu", "before = static_cast<int>(look_back(status + t, kMaxBins, tile));", "before = 0;"),
    ],
    "diagnostic: stores in input order (wrong output)": [
        ("radix_sort.cu", "dst[k] = shift[digit.of(key)] + r;", "dst[k] = static_cast<int>(base) + r + 0 * shift[digit.of(key)];"),
    ],
    "histogram: 512 threads per CTA": [
        ("radix_sort.cu", "constexpr int kHistThreads = 1024;", "constexpr int kHistThreads = 512;"),
    ],
    "scan tile 4096 (256 threads x 16)": [
        ("scan.cu", "constexpr int kScanItems = 32;", "constexpr int kScanItems = 16;"),
    ],
    "scan tile 8192 (512 threads x 16)": [
        ("scan.cu", "constexpr int kScanThreads = 256;", "constexpr int kScanThreads = 512;"),
        ("scan.cu", "constexpr int kScanItems = 32;", "constexpr int kScanItems = 16;"),
    ],
    "scan tile 16384 (256 threads x 64)": [
        ("scan.cu", "constexpr int kScanItems = 32;", "constexpr int kScanItems = 64;"),
    ],
    "scan: at least 4 CTAs per SM": [
        ("scan.cu", "__launch_bounds__(kScanThreads)", "__launch_bounds__(kScanThreads, 4)"),
    ],
    "scan look-back: waits on the window of 32 tiles before it": [
        ("scan.cu", "constexpr int kWindows = 8;", "constexpr int kWindows = 1;"),
    ],
    "scan look-back: walks down 3 windows before it waits": [
        ("scan.cu", "constexpr int kWindows = 8;", "constexpr int kWindows = 4;"),
    ],
}


def variant_sources(name: str) -> dict:
    """{file name: text} of every kernel source with the variant's edits;
    raises ValueError when an edit's text is not found exactly once."""
    texts = {f.name: f.read_text() for f in CSRC.glob("*.cu*")}
    for file, old, new in VARIANTS[name]:
        if texts[file].count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} is not found exactly once in {file}")
        texts[file] = texts[file].replace(old, new)
    return texts


def _ptxas(log: str, mangled: str) -> str:
    """ptxas's registers and spills of the kernel whose mangled name holds `mangled`."""
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines) if "Compiling entry" in line and mangled in line)
    spills = next(line for line in lines[at:] if "spill stores" in line).strip()
    registers = next(line for line in lines[at:] if "Used" in line).split(":", 1)[1].strip()
    return f"{registers}; {spills}"


def _write_sources(name: str) -> pathlib.Path:
    folder = OUT / f"v{list(VARIANTS).index(name)}"
    folder.mkdir(parents=True, exist_ok=True)
    for file, text in variant_sources(name).items():
        (folder / file).write_text(text)
    return folder


def _write_baseline(root: pathlib.Path) -> pathlib.Path:
    folder = OUT / "baseline"
    folder.mkdir(parents=True, exist_ok=True)
    for f in (root / "glu_tpu_torch" / "csrc").glob("*.cu*"):
        (folder / f.name).write_text(f.read_text())
    return folder


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The signatures of the entries the tool calls."""
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    for name in ("glu_sort_tile", "glu_scan_tile"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = [], c_int
    lib.glu_digit_histograms.argtypes = [ptr, c_int, ptr, ptr, c_int, ptr, ptr]
    lib.glu_onesweep_pass.argtypes = [ptr, ptr, c_int, c_int, ptr, c_int, ptr, ptr, ptr]
    lib.glu_scan_pass.argtypes = [ptr, ptr, c_int, ctypes.c_longlong, c_int, c_int, ptr, ptr]
    for name in ("glu_digit_histograms", "glu_onesweep_pass", "glu_scan_pass"):
        getattr(lib, name).restype = c_int
    if hasattr(lib, "glu_onesweep_ctas_per_sm"):
        lib.glu_onesweep_ctas_per_sm.argtypes, lib.glu_onesweep_ctas_per_sm.restype = [c_int], c_int
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=pathlib.Path,
                        help="a checkout whose glu_tpu_torch/csrc is built and timed beside the variants")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("onesweep_variants: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from glu_tpu_torch import _build
    from glu_tpu_torch.ops import _cuda_scan as csc
    from glu_tpu_torch.ops import _cuda_sort as cs

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(gpu)
    folders = [(name, _write_sources(name)) for name in VARIANTS]
    if args.baseline is not None:
        folders.append((f"baseline {args.baseline}", _write_baseline(args.baseline.resolve())))
    builds = [(name, folder / "lib.so") for name, folder in folders]
    results = _build.run_all([_build.nvcc_command(sorted(folder.glob("*.cu")), folder / "lib.so", shared=True)
                              for _, folder in folders])
    libs = {}
    for (name, so), (rc, out) in zip(builds, results):
        if rc != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        lib = _bind(ctypes.CDLL(str(so)))
        report = "; ".join(f"{kernel}: {_ptxas(out, mangled)}" for kernel, mangled in (
            ("onesweep_pass_kernel", "onesweep_pass_kernel"),
            ("scan_onepass_kernel<SUM, u32, 4>", "scan_onepass_kernelILi0EjLi4E")))
        if hasattr(lib, "glu_onesweep_ctas_per_sm"):
            report += f"; CTAs an SM: {lib.glu_onesweep_ctas_per_sm(2)} (2 streams), " \
                      f"{lib.glu_onesweep_ctas_per_sm(3)} (3 streams)"
        libs[name] = (lib, lib.glu_sort_tile(), lib.glu_scan_tile(), report)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    keys = torch.randint(-(2**31), 2**31, (N,), dtype=torch.int32, device=dev, generator=gen)
    vals = torch.arange(N, dtype=torch.int32, device=dev)
    more = torch.randint(-(2**31), 2**31, (N,), dtype=torch.int32, device=dev, generator=gen)
    pos = tuple(range(8))
    groups = [tuple(range(8 * p, 8 * p + 8)) for p in range(4)]
    want_hist = cs.digit_histograms_ref(keys, groups)
    base = (torch.cumsum(want_hist, 1, dtype=torch.int32) - want_hist)[0].contiguous()
    want_k, want_p = cs.onesweep_pass_ref(keys, [vals, more], pos, base)
    want = [want_k, *want_p]
    want_scan = torch.cumsum(keys, 0, dtype=torch.int32) - keys  # u32 sums as int32 words: exact
    outs = [torch.empty_like(keys) for _ in range(3)]
    scan_out = torch.empty_like(keys)
    hist = torch.zeros_like(want_hist)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])  # noqa: E731

    def elapsed_ms(fn) -> float:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def steps_of(name: str, lib, tile: int, scan_tile: int) -> dict:
        """{step: a function that runs it once}: each launch after the zeroing
        of its status words or counts, and that zeroing alone."""
        status = torch.zeros(-(-N // tile) * 256 + 1, dtype=torch.int64, device=dev)
        scan_status = torch.zeros(csc.status_words(-(-N // scan_tile), torch.uint32), dtype=torch.int64, device=dev)

        def checked(err: int, entry: str) -> None:
            if err:
                raise RuntimeError(f"variant {name!r}: {entry} returned cudaError {err}")

        def one_pass(nstreams: int) -> None:
            status.zero_()
            checked(lib.glu_onesweep_pass(ptrs([keys, vals, more][:nstreams]), ptrs(outs[:nstreams]), nstreams, N,
                                          (ctypes.c_int * 8)(*pos), 8, base.data_ptr(), status.data_ptr(), stream()),
                    "glu_onesweep_pass")

        def histograms() -> None:
            hist.zero_()
            checked(lib.glu_digit_histograms(keys.data_ptr(), N, (ctypes.c_int * 32)(*range(32)),
                                             (ctypes.c_int * 4)(8, 8, 8, 8), 4, hist.data_ptr(), stream()),
                    "glu_digit_histograms")

        def scan() -> None:
            scan_status.zero_()
            checked(lib.glu_scan_pass(keys.data_ptr(), scan_out.data_ptr(), 1, N, 1, 0, scan_status.data_ptr(),
                                      stream()), "glu_scan_pass")  # uint32 (code 1), SUM (0)

        return {"status": status.zero_, "pass": lambda: one_pass(2), "pass3": lambda: one_pass(3),
                "hist zeroing": hist.zero_, "hist": histograms, "scan status": scan_status.zero_, "scan": scan}

    # every library's steps in turns, REPS rounds after one unrecorded, so that
    # a drift of the card's clocks falls on every variant alike
    steps = {name: steps_of(name, lib, tile, scan_tile) for name, (lib, tile, scan_tile, _) in libs.items()}
    times = {name: {step: [] for step in steps[name]} for name in libs}
    failed = {}
    for rnd in range(REPS + 1):
        for name in libs:
            if name in failed:
                continue
            try:
                for step, fn in steps[name].items():
                    ms = elapsed_ms(fn)
                    if rnd:
                        times[name][step].append(ms)
            except RuntimeError as e:  # a launch the variant's library refuses; the card is still sound
                failed[name] = e

    for name, (lib, tile, scan_tile, report) in libs.items():
        if name in failed:
            print(f"{name}: not timed: {failed[name]}; {report} [{gpu}]", flush=True)
            continue
        ms = {step: sorted(t)[REPS // 2] for step, t in times[name].items()}
        pass_ms, pass3_ms = ms["pass"] - ms["status"], ms["pass3"] - ms["status"]
        hist_ms, scan_ms = ms["hist"] - ms["hist zeroing"], ms["scan"] - ms["scan status"]
        run = steps[name]
        run["pass"]()
        right = torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1])
        run["pass3"]()
        run["hist"]()
        run["scan"]()
        right = right and all(torch.equal(o, w) for o, w in zip(outs, want))
        right = right and torch.equal(hist, want_hist) and torch.equal(scan_out, want_scan)
        print(f"{name}: tile {tile}; onesweep_pass {pass_ms:.4f} ms = {N * 16 / pass_ms / 1e6:.0f} GB/s, "
              f"3 streams {pass3_ms:.4f} ms = {N * 24 / pass3_ms / 1e6:.0f} GB/s; "
              f"digit_histograms {hist_ms:.4f} ms; exclusive scan (tile {scan_tile}) {scan_ms:.4f} ms; "
              f"output {'right' if right else 'WRONG'}; "
              f"{report} [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
