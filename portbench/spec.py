"""Finds a cell's pieces by name: the cell in ``BENCHMARK.json``, its
configuration, its traffic mix, its corpus generator, its index adapter and
the readers of its per-layer metrics. A new configuration, traffic mix or
metric is a new file and a new entry; nothing here changes for it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, benchmark: Optional[Path] = None,
              base: Path = HERE) -> Cell:
    """The cell ``workload`` of ``benchmark`` (``BENCHMARK.json`` at the
    repository root) with its configuration and traffic read from ``base``;
    the metrics are those the benchmark gives the cell."""
    bench = _read_json(benchmark or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the benchmark ({sorted(cells)})")
    w = cells[workload]
    config = _read_json(base / "configs" / f"{w['config']}.json")
    traffic = _read_json(base / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return Cell(name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=layer)


def corpus_generator(name: str, base: Path = HERE) -> ModuleType:
    return load_module(base / "corpora" / f"{name}.py", f"portbench_corpus_{name}")


def index_adapter(kind: str, base: Path = HERE) -> ModuleType:
    return load_module(base / "indexes" / f"{kind}.py", f"portbench_index_{kind}")


def metric_readers(names: List[str], base: Path = HERE) -> Dict[str, ModuleType]:
    return {n: load_module(base / "metrics" / f"{n}.py",
                           "portbench_metric_" + n.replace(".", "_").replace("-", "_"))
            for n in names}
