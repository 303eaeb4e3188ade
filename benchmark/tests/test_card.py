"""On a card (marker `cuda`; skipped elsewhere): every one-card cell runs
through benchmark/run.py for a second and comes out correct, with the
card's name on its line."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["u32_2p28_1card.sort_uniform", "u32_small_1card.sort_closed",
                                  "u32_2p28_1card.scan_reduce"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", cell, "--seed", "4294967301",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
