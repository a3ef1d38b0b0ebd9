"""A run whose timed path is broken underneath reads ``correct`` false,
for each fault of ``control.FAULTS``: half of each batch answered with the
other half's answers, one answer altered where it is produced, each
request answered with the last one's (state left unchanged), the refine
given half its candidates, fewer lists probed, and any k rows of a probed
list scored exactly. The control, the reference in TF32 in the program's
place, reads false too. There is no exchange between chips to leave out:
every cell takes one."""

import pytest

from portbench import control, run
from portbench.tests.conftest import tiny_cell

# the number each fault has to fail (at least): the last three return exact
# scores of ids from probed lists, which only ``missed`` can tell from sound
CAUGHT_BY = {"half_batch": "score_err", "altered": "score_err", "unchanged": "score_err",
             "refine_half": "missed", "nprobe_less": "missed", "first_k_of_list": "missed"}


# the tiny partition cell's rerank of 20, halved to k, is skipped: the probe's
# bf16 scores come back
CAUGHT_BY_IN = {("tiny.partition", "refine_half"): "score_err"}
CASES = [(c, f) for c in ("tiny.ivfpq", "tiny.partition") for f in sorted(control.FAULTS)]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = run.run_cell(tiny_cell(cell), 11, 0.2, False, device="cpu",
                       served_factory=control.arm_factory(fault, {}))
    assert res["correct"] is False, res["checks"]
    c = res["checks"][CAUGHT_BY_IN.get((cell, fault), CAUGHT_BY[fault])]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny.ivfpq", "tiny.partition"])
def test_the_control_is_not_correct_and_the_program_is(cell):
    built = {}
    ctl = run.run_cell(tiny_cell(cell), 12, 0.2, False, device="cpu",
                       served_factory=control.arm_factory("control", built))
    assert ctl["correct"] is False
    assert ctl["checks"]["score_err"]["value"] > ctl["checks"]["score_err"]["limit"]
    ok = run.run_cell(tiny_cell(cell), 12, 0.2, False, device="cpu",
                      served_factory=control.arm_factory("program", built))
    assert ok["correct"] is True and ok["checks"]["missed"]["value"] == 0, ok["checks"]
