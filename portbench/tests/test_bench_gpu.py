"""On the card: the tiny cells run through the port's kernels and read
``correct`` true, the control false, and a traced run reads the device."""

import pytest

from portbench import control, run
from portbench.tests.conftest import tiny_cell


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny.ivfpq", "tiny.partition"])
def test_tiny_cell_on_the_card(cell, cuda_device):
    res = run.run_cell(tiny_cell(cell), 21, 0.5, True, device=cuda_device)
    assert res["correct"] is True and res["device"]["busy_s"] > 0
    ctl = run.run_cell(tiny_cell(cell), 21, 0.5, False, device=cuda_device,
                       served_factory=control.arm_factory("control", {}))
    assert ctl["correct"] is False
