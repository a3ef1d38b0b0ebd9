"""Every piece of a cell is found by name, and BENCHMARK.json keeps to the
benchmark contract's shape."""

import json
import re

import pytest

from portbench import spec
from portbench.tests.conftest import DATA

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert spec.corpus_generator(c.config["corpus"]["generator"]).generate
    assert spec.index_adapter(c.config["index"]["kind"]).Served
    readers = spec.metric_readers([m["name"] for m in c.per_layer])
    assert set(readers) == {m["name"] for m in c.per_layer} and readers
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "qps"}
    assert set(c.config["limits"]) >= {"bad_results", "score_err", "off_probe", "unplaced_rows"}


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file() and len(c["source"]) <= 200
        assert json.loads((spec.ROOT / c["file"]).read_text())["source"] == c["source"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    base = tmp_path / "pb"
    for sub in ("configs", "traffic", "metrics"):
        (base / sub).mkdir(parents=True)
    cfg = json.loads((DATA / "configs" / "tiny-ivfpq.json").read_text())
    cfg["name"] = "dummy-config"
    (base / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 2, "pool": 16, "perturb": 0.0}))
    (base / "metrics" / "dummy.metric.py").write_text("def read(t):\n    return 42.0\n")
    bench = dict(BENCH, workloads=[{"name": "dummy.cell", "config": "dummy-config",
                                    "traffic": "dummy_mix", "chips": 1, "why": "test"}],
                 per_layer=[{"name": "dummy.metric", "unit": "%", "better": "higher",
                             "source": "device_trace", "layer": "device", "moves": "qps"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("dummy.cell", tmp_path / "BENCHMARK.json", base)
    assert cell.config["name"] == "dummy-config" and cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy.metric"]
    assert spec.metric_readers(["dummy.metric"], base)["dummy.metric"].read(None) == 42.0
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", tmp_path / "BENCHMARK.json", base)
