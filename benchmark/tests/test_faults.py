"""Each fault a cell can have, planted under its timed path, turns
`correct` false, and so does the control in the program's place."""

import pytest

from benchmark.tests import cells

ONE_CARD = ["u32_2p28_1card.sort_uniform", "u32_small_1card.sort_closed", "u32_2p28_1card.scan_reduce"]
DIST = "u32_2p30_4card.dist_sort_skew"
CASES = [(c, f) for c in ONE_CARD for f in ("unchanged", "half_batch", "altered")]
CASES += [(DIST, f) for f in ("unchanged", "half_batch", "no_exchange", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    result = cells.run(cell, patch=f"benchmark.tests.faults:{fault}")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ONE_CARD + [DIST])
def test_control_is_not_correct(cell):
    result = cells.run(cell, patch="benchmark.control:use_control")
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["answers_checked"]["value"] > 0


@pytest.mark.parametrize("cell", ONE_CARD + [DIST])
def test_sound_run_is_correct(cell):
    result = cells.run(cell, trace=cell == DIST)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(c["value"] == 0 for k, c in result["checks"].items() if k != "answers_checked")
