#!/usr/bin/env python3
"""Times design variants of the sort's kernels on one NVIDIA GPU.

    python3 tools/onesweep_variants.py          # from the root of the repository

Each variant is the kernel library, glu_tpu_torch/csrc, as it stands, with a
few lines of radix_sort.cu or lookback.cuh replaced: another tile shape, another ranker,
other memory orders on the status words, the payloads loaded later, and two
diagnostics that drop a step (their output is wrong; they bound that step's
cost). Every variant is built with nvcc into glu_tpu_torch/_build/variants/
(listed in .gitignore), one nvcc per variant, all at once, and timed with
CUDA events on 2^28 u32 key/value pairs: one 8-bit onesweep pass (the
status words' zeroing is timed alone and subtracted) and digit_histograms
over 4 passes of 8 bits. Each variant's output is checked against the plain
torch versions. The card's name and power limit come first; one line per
variant follows. Needs a CUDA device and nvcc; writes nothing else.

The edits name exact text of the sources, so an edit of those lines breaks
a variant: tests/test_torch_build.py checks on the CPU that every
variant still applies. The library is built and bound by glu_tpu_torch's
own _build (nvcc_command, run_all, bind_signatures).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "glu_tpu_torch" / "csrc"
OUT = ROOT / "glu_tpu_torch" / "_build" / "variants"
N = 1 << 28
REPS = 7

# name: [(file, text in the source, replacement), ...]
VARIANTS = {
    "as built": [],
    "tile 4096 (256 threads x 16, 3 CTAs/SM)": [
        ("radix_sort.cu", "constexpr int kTileThreads = 384;", "constexpr int kTileThreads = 256;"),
        ("radix_sort.cu", "constexpr int kTileCtasPerSm = 2;", "constexpr int kTileCtasPerSm = 3;"),
    ],
    "tile 8192 (512 threads x 16, 2 CTAs/SM)": [
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


def _write_sources(name: str) -> pathlib.Path:
    folder = OUT / f"v{list(VARIANTS).index(name)}"
    folder.mkdir(parents=True, exist_ok=True)
    for file, text in variant_sources(name).items():
        (folder / file).write_text(text)
    return folder


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("onesweep_variants: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from glu_tpu_torch import _build
    from glu_tpu_torch.ops import _cuda_sort as cs

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(gpu)
    builds = []
    for name in VARIANTS:
        folder = _write_sources(name)
        so = folder / "lib.so"
        builds.append((name, so, _build.nvcc_command(sorted(folder.glob("*.cu")), so, shared=True)))
    results = _build.run_all([cmd for _, _, cmd in builds])
    libs = {}
    for (name, so, _), (rc, out) in zip(builds, results):
        if rc != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        lib = _build.bind_signatures(ctypes.CDLL(str(so)))
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines) if "Compiling entry" in line and "onesweep_pass_kernel" in line)
        spills = next(line for line in lines[at:] if "spill stores" in line).strip()
        registers = next(line for line in lines[at:] if "Used" in line).split(":", 1)[1].strip()
        report = f"{registers}; {spills}"
        libs[name] = (lib, lib.glu_sort_tile(), report)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    keys = torch.randint(-(2**31), 2**31, (N,), dtype=torch.int32, device=dev, generator=gen)
    vals = torch.arange(N, dtype=torch.int32, device=dev)
    pos = tuple(range(8))
    groups = [tuple(range(8 * p, 8 * p + 8)) for p in range(4)]
    want_hist = cs.digit_histograms_ref(keys, groups)
    base = (torch.cumsum(want_hist, 1, dtype=torch.int32) - want_hist)[0].contiguous()
    want = cs.onesweep_pass_ref(keys, [vals], pos, base)
    outs = [torch.empty_like(keys), torch.empty_like(vals)]
    hist = torch.zeros_like(want_hist)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])  # noqa: E731

    def median_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[REPS // 2]

    for name, (lib, tile, report) in libs.items():
        status = torch.zeros(-(-N // tile) * 256 + 1, dtype=torch.int64, device=dev)

        def one_pass():
            status.zero_()
            err = lib.glu_onesweep_pass(ptrs([keys, vals]), ptrs(outs), 2, N, (ctypes.c_int * 8)(*pos), 8,
                                        base.data_ptr(), status.data_ptr(), stream())
            if err:
                raise RuntimeError(f"variant {name!r}: glu_onesweep_pass returned cudaError {err}")

        def histograms():
            hist.zero_()
            err = lib.glu_digit_histograms(keys.data_ptr(), N, (ctypes.c_int * 32)(*range(32)),
                                           (ctypes.c_int * 4)(8, 8, 8, 8), 4, hist.data_ptr(), stream())
            if err:
                raise RuntimeError(f"variant {name!r}: glu_digit_histograms returned cudaError {err}")

        pass_ms = median_ms(one_pass) - median_ms(status.zero_)
        hist_ms = median_ms(histograms) - median_ms(hist.zero_)
        one_pass()
        histograms()
        right = torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1][0]) and torch.equal(hist, want_hist)
        print(f"{name}: tile {tile}; onesweep_pass {pass_ms:.4f} ms = {N * 16 / pass_ms / 1e6:.0f} GB/s; "
              f"digit_histograms {hist_ms:.4f} ms; output {'right' if right else 'WRONG'}; "
              f"onesweep_pass_kernel: {report} [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
