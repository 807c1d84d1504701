"""On the card (``python -m pytest -m cuda portbench/tests``): the
control at a cell's own size comes out above the cell's limits, and a
short run of the cell comes out correct.  Skipped without a card."""
import pytest

from portbench import control, harness

CELL = "hymba-1.5b.b1s512"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
def test_fp8_control_fails_the_check(cuda, seed):
    cell = harness.load_cell(CELL)
    checks = control.control_checks(cell, seed)
    assert any(v > cell.limits[k] for k, v in checks.items()), checks


@pytest.mark.cuda
def test_a_short_run_is_correct(cuda):
    result = harness.run_cell(harness.load_cell(CELL), seed=2 ** 31 + 7,
                              seconds=2.0, trace=False)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["kind"].startswith("NVIDIA")
