"""On the card, at each cell's own size: the control (the plain reference
in float8 in the program's place) comes out not correct by the cell's own
limits.  Run on a card: ``python -m pytest benchmark/tests -m gpu``."""
import pytest

from benchlib import cells

SEED = 987654321987


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vg.sample", "coco.sample", "vg.train"])
def test_control_is_not_correct(card, name):
    cell = cells.load(name)
    drv = cell.driver()
    if cell.traffic["kind"] == "sample":
        nums = drv.control(cell, SEED, card, 3)
    else:
        nums = drv.control(cell, SEED, card, cell.chips)
    assert any(nums[k] > lim for k, lim in cell.limits.items() if k in nums), nums
