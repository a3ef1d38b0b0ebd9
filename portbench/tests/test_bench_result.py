"""The result object of a run: its keys, its metrics, and ``checks`` last;
no card, no result."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run, spec
from portbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(trace):
    cell = tiny_cell("tiny.ivfpq")
    res = run.run_cell(cell, 2**31 + 5, 0.2, bool(trace), device="cpu")
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "ivfpq.b256",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
