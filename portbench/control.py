"""The control of ``correct`` and the planted faults: what serves a cell's
requests in the program's place, and must read ``correct`` false.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]
        [--arms program control refine_half ...] [--seconds S]

For each seed it builds the program's index once, as ``portbench.run``
does, and runs the cell once an arm, each answering every request its own
way, then prints the numbers compared beside their limits:

- ``program``: the program itself (a sound run, for the lower readings);
- ``control``: the reference in TF32 (``reference.control_search``);
- the faults of ``FAULTS``: the program with its timed path broken.

A sound harness reads ``correct`` true for ``program`` and false for every
other arm. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import copy
import json
import sys

import torch

from portbench import reference, run, spec


class Faulty:
    """The program's index, its answers broken by ``fault`` (one of
    ``FAULTS``); ``inner`` is the index adapter's ``Served``."""

    def __init__(self, inner, fault: str, cfg: dict, rows, seed: int, device):
        if fault not in FAULTS:
            raise KeyError(f"no fault {fault!r} ({sorted(FAULTS)})")
        self.inner, self.fault, self.last = copy.copy(inner), fault, None
        self.n = rows.shape[0]
        self.metric = cfg["search"]["metric"]
        if fault == "refine_half":
            for key in ("refine_k", "rerank_k"):
                if hasattr(self.inner, key):
                    setattr(self.inner, key, getattr(self.inner, key) // 2)
        elif fault == "nprobe_less":
            self.inner.nprobe -= max(1, self.inner.nprobe // 8)
        elif fault == "first_k_of_list":
            self.rows = torch.from_numpy(rows).to(device)
            view = inner.state(seed)
            self.slot_ids = view.slot_ids
            self.list_of = reference.list_of_rows(view, rows.shape[0])

    def search(self, q: torch.Tensor):
        v, i = self.inner.search(q)
        if self.fault == "half_batch":
            h = (q.shape[0] + 1) // 2
            v, i = torch.cat([v[:h], v[:q.shape[0] - h]]), torch.cat([i[:h], i[:q.shape[0] - h]])
        elif self.fault == "altered":
            i = i.clone()
            i[0, 0] = (i[0, 0] + 1) % self.n
        elif self.fault == "unchanged":
            prev, self.last = self.last, (v, i)
            v, i = prev if prev is not None else (v, i)
        elif self.fault == "first_k_of_list":
            # any k ids of a probed list, scored exactly: the best answer's list, from its start
            lst = self.list_of[i[:, 0].long()]
            i = self.slot_ids[lst, :v.shape[1]]
            r = self.rows[i.long()]
            dots = (q[:, None, :r.shape[2]] * r).sum(2)
            s = dots if self.metric == "dot" else 2.0 * dots - (r * r).sum(2)
            v, pos = torch.sort(s, dim=1, descending=True)
            i = torch.gather(i, 1, pos)
        return v, i

    def state(self, seed: int):
        return self.inner.state(seed)

    def shape(self, batch: int) -> dict:
        return self.inner.shape(batch)


# the faults a cell's timed path can have (there is no exchange between
# chips to leave out: every cell takes one)
FAULTS = {
    "half_batch": "half of each batch answered with the other half's answers",
    "altered": "one id of each request altered where it is produced",
    "unchanged": "each request answered with the last one's (state left unchanged)",
    "refine_half": "the exact refine / rerank given half its candidates",
    "nprobe_less": "an eighth fewer lists probed",
    "first_k_of_list": "the first k rows of the best answer's list, scored exactly",
}


class ControlServed:
    """The program's index, as a run builds it, with every request
    answered by the TF32 reference from the benchmark's own rows."""

    def __init__(self, inner, cfg: dict, rows, seed: int, device):
        self.program = inner
        self.corpus = torch.from_numpy(rows).to(device)
        self.view = inner.state(seed)
        self.search_cfg = cfg["search"]

    def search(self, q: torch.Tensor):
        return reference.control_search(q, self.corpus, self.view, self.search_cfg)

    def state(self, seed: int):
        return self.view

    def shape(self, batch: int) -> dict:
        return self.program.shape(batch)


def arm_factory(arm: str, built: dict):
    """The ``served_factory`` of ``arm``; ``built`` keeps the program's
    index of the last seed, so that the arms of one seed share one build."""
    def factory(cfg, rows, seed, device):
        if built.get("seed") != seed:
            built.clear()
            built["seed"] = seed
            built["served"] = spec.index_adapter(cfg["index"]["kind"]).Served(
                cfg, rows, seed, device)
        inner = built["served"]
        if arm == "program":
            return inner
        if arm == "control":
            return ControlServed(inner, cfg, rows, seed, device)
        return Faulty(inner, arm, cfg, rows, seed, device)
    return factory


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--arms", nargs="+", default=["program", "control"],
                   choices=["program", "control", *FAULTS])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 1
    built: dict = {}
    for seed in args.seeds:
        for arm in args.arms:
            res = run.run_cell(cell, seed, args.seconds, False,
                               served_factory=arm_factory(arm, built))
            print(json.dumps({"arm": arm, "workload": args.workload, "seed": seed,
                              "correct": res["correct"], "attempted": res["attempted"],
                              "failed": res["failed"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
