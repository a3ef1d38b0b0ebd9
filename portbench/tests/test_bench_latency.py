"""The latency tail is the interpolated percentile of every request, the
reference's pct() that ``eval/stats.py`` carries."""

import numpy as np
import pytest

from nvdb_tpu_torch.eval import stats
from portbench import run


@pytest.mark.parametrize("n", [1, 2, 7, 100, 12345])
def test_percentile_is_the_reference_pct(n):
    vals = sorted(np.random.default_rng(n).exponential(1.0, n).tolist())
    for p in (50, 95, 99):
        assert run.percentile(vals, p) == stats.percentile(vals, p)
        assert run.percentile(vals, p) == pytest.approx(float(np.percentile(vals, p)))


def test_the_latency_tail_of_a_run_is_over_all_requests():
    from portbench.tests.conftest import tiny_cell

    res = run.run_cell(tiny_cell("tiny.partition"), 5, 0.2, False, device="cpu")
    assert res["metrics"]["latency_p90_ms"]["value"] > 0
    assert res["attempted"] % 8 == 0 and res["attempted"] >= 8
