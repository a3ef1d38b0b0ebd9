"""The IVF-OPQ-PQ adapter (``ivfpq.py``, whose ``Served`` serves the
requests) for a deployment whose index is built on the card: before the
build, a probe build of the corpus's first ``PROBE_ROWS`` rows at the
configuration's width (``PROBE_LISTS`` lists, its m, its OPQ), with the
program's spans recorded (``eval/trace.py``), must show each ``build.*``
stage with ``where`` = ``device``. A program that builds such a corpus on
the host, or records no build stages, fails at once, where its build of
the whole corpus would take many minutes."""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from portbench import spec

PROBE_ROWS = 4096
PROBE_LISTS = 16

_base = spec.load_module(spec.HERE / "indexes" / "ivfpq.py", "portbench_index_ivfpq")


def probe_build(cfg: dict, rows: np.ndarray, seed: int, device) -> None:
    """Raises unless a small build of ``rows``' first rows records every
    stage on the card."""
    ix = cfg["index"]
    with trace.recording() as rec:
        IVFPQIndex.build(rows[:PROBE_ROWS], nlist=PROBE_LISTS, m=int(ix["m"]),
                         use_opq=bool(ix["opq"]), train_size=PROBE_ROWS, n_iters=2,
                         opq_iters=1, cb_iters=2, seed=seed, device=device)
    where = {r.attrs.get("where") for r in rec.records if r.name.startswith("build.")}
    if where != {"device"}:
        raise RuntimeError(f"the program does not build this index on the card: its build "
                           f"stages record where={sorted(map(str, where))} (none: no stages)")


class Served(_base.Served):
    def __init__(self, cfg: dict, rows: np.ndarray, seed: int, device):
        probe_build(cfg, rows, seed, device)
        super().__init__(cfg, rows, seed, device)
