"""The program's own spans on the device trace's clock: the records of
``nvdb_tpu_torch.eval.trace`` (one root span a ``search_device`` call, the
stages and kernel wrappers below it) beside the traced window's device
activities and their CPU-side launch records, and the per-layer numbers
read from them:

- ``index.host_ms``: ms a request of the root search span (``ivfpq.search``
  or ``partition.search``);
- ``dispatch.wrapper_host_ms``: ms a request inside the kernel wrappers'
  spans (their ``launch`` children included);
- ``index.coarse_ms``: device ms a request of the kernels launched inside a
  ``coarse`` span; None where fewer than 95% of the window's kernels that
  are not the port's own matched a launch record;
- ``dispatch.alloc_mb_per_req``: the wrapper spans' ``alloc_bytes`` a
  request, in MB.

Each is None where the trace holds no program spans (a program without the
recorder). ``run.py`` does not open the recorder itself yet; until it does,

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> [--trace 0]

makes one traced run of the cell (``run.run_cell`` with ``--trace 1``)
inside ``recording()``, with the profiler, the ``Trace`` and the metric
readers of ``run_cell`` wrapped to carry the records and the launch
records, and prints its result line with these numbers and the labelled
idle gaps, and on standard error the checks that the two clocks agree and
each span's self time a request. ``--trace 0``: the recorder alone, no
profiler, for the host's split without CUPTI's cost a launch."""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import functools
import json
import re
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple
from unittest import mock

from portbench import spec
from portbench.trace import Trace

ROOTS = ("ivfpq.search", "partition.search")
WRAPPERS = ("adc_fused_keys_cuda", "adc_fused_topk_cuda", "ivf_probe_topk_cuda",
            "rerank_topk_cuda")
MIN_MATCHED = 0.95   # share of the other kernels with a launch record index.coarse_ms needs

# (name, start_ns, end_ns, parent, request, attrs), on the profiler's clock
Record = Tuple[str, int, int, int, int, dict]


@functools.cache
def _port_rx() -> "re.Pattern":
    """The port's own kernels as ``index.plain_torch_ms`` tells them apart."""
    reader = spec.metric_readers(["index.plain_torch_ms"])["index.plain_torch_ms"]
    return re.compile("|".join(reader.PORT_KERNELS))


def program_records(tracer, clock_offset: int) -> List[Record]:
    """A recorder's spans moved onto the profiler's clock
    (``perf_counter_ns`` + ``clock_offset``)."""
    return [(r.name, r.start_ns + clock_offset, r.end_ns + clock_offset, r.parent,
             r.request, r.attrs) for r in tracer.records]


def _events(prof):
    """The device events of a finished ``torch.profiler.profile``, in the
    order ``trace.device_activities`` reads them, and its CPU-side records
    (the API calls that launched them, such as ``cudaLaunchKernel``) by
    correlation id."""
    device, host = [], {}
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).split(".")[-1] == "CUDA":
            device.append(ev)
        elif ev.correlation_id():
            host[ev.correlation_id()] = ev
    return device, host


def launch_starts(prof) -> List[Optional[int]]:
    """Each device activity's launch start, aligned with
    ``trace.device_activities``; None where the trace holds no record."""
    device, host = _events(prof)
    return [host[ev.correlation_id()].start_ns() if ev.correlation_id() in host else None
            for ev in device]


def launch_names(prof) -> Dict[str, int]:
    """Launch records by name, with the number of device activities each
    launched: what the card's trace carries for each kind of launch."""
    device, host = _events(prof)
    out: Dict[str, int] = {}
    for ev in device:
        rec = host.get(ev.correlation_id())
        name = rec.name() if rec is not None else "(no launch record)"
        out[name] = out.get(name, 0) + 1
    return out


@dataclasses.dataclass
class SpanTrace(Trace):
    """A ``Trace`` with the program's records and each activity's launch
    start (``launch_ns``, aligned with ``activities``; None: unmatched)."""
    spans: List[Record] = dataclasses.field(default_factory=list)
    launch_ns: List[Optional[int]] = dataclasses.field(default_factory=list)

    def roots(self) -> List[int]:
        """Indices of the root search spans that start inside the window."""
        return [j for j, r in enumerate(self.spans)
                if r[3] < 0 and r[0] in ROOTS and self.t0_ns <= r[1] < self.t1_ns]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """``Trace.idle_gaps``, with a gap inside the client's
        ``search_device`` phase labelled also by the innermost program span
        at its middle (``host in search_device: coarse``); the labels are
        ``Trace``'s where the trace holds no program spans."""
        if not self.spans:
            return super().idle_gaps(n)
        tot = {k: round(v * 1e9) for k, v in super().idle_gaps(10**9)}
        starts = [r[1] for r in self.spans]
        depth = []
        for r in self.spans:
            depth.append(0 if r[3] < 0 else depth[r[3]] + 1)
        calls = sorted(r["search_device"] for r in self.requests)
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for se in busy for x in se] + [self.t1_ns]
        for j in range(0, len(edges), 2):
            s, e = edges[j], edges[j + 1]
            mid = (s + e) // 2
            if e <= s or not _inside(calls, mid):
                continue
            # the innermost span open at mid: walk back from the last span
            # opened before it to the root of its request
            best, k = None, bisect.bisect_right(starts, mid) - 1
            while k >= 0:
                name, a, b, parent = self.spans[k][:4]
                if a <= mid < b and (best is None or depth[k] > depth[best]):
                    best = k
                if parent < 0:
                    break
                k -= 1
            if best is not None:
                label = f"host in search_device: {self.spans[best][0]}"
                tot[label] = tot.get(label, 0) + (e - s)
                tot["host in search_device"] -= e - s
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                if v > 0][:n]


def _per_request(t: Trace, names, value) -> Optional[float]:
    roots = t.roots() if getattr(t, "spans", None) else []
    if not roots:
        return None
    lo, hi = roots[0], len(t.spans)
    return sum(value(r) for r in t.spans[lo:hi] if r[0] in names
               and r[1] < t.t1_ns) / len(roots)


def host_ms(t: Trace) -> Optional[float]:
    return _per_request(t, ROOTS, lambda r: (r[2] - r[1]) / 1e6)


def wrapper_host_ms(t: Trace) -> Optional[float]:
    return _per_request(t, WRAPPERS, lambda r: (r[2] - r[1]) / 1e6)


def alloc_mb_per_req(t: Trace) -> Optional[float]:
    return _per_request(t, WRAPPERS, lambda r: r[5].get("alloc_bytes", 0) / 1e6)


def _kernels_with_launch(t: SpanTrace) -> List[Tuple[str, int, int, Optional[int]]]:
    return [(a[0], a[1], a[2], ln) for a, ln in zip(t.activities, t.launch_ns)
            if a[3] == "kernel"]


def _inside(spans: List[Tuple[int, int]], x: int) -> bool:
    """Whether ``x`` lies in one of ``spans`` (sorted, not overlapping)."""
    j = bisect.bisect_right(spans, (x, 1 << 62)) - 1
    return j >= 0 and x < spans[j][1]


def _spans_named(t: SpanTrace, name: str) -> List[Tuple[int, int]]:
    return sorted((r[1], r[2]) for r in t.spans if r[0] == name)


def matched_share(t: SpanTrace, ours: bool) -> Optional[float]:
    """The share of the window's kernels, the port's own (``ours``) or the
    others, that matched a launch record."""
    ks = [k for k in _kernels_with_launch(t) if bool(_port_rx().search(k[0])) == ours]
    return sum(k[3] is not None for k in ks) / len(ks) if ks else None


def coarse_ms(t: Trace) -> Optional[float]:
    if (not getattr(t, "spans", None) or not t.requests
            or (matched_share(t, False) or 0.0) < MIN_MATCHED):
        return None
    coarse = _spans_named(t, "coarse")
    dev = sum(e - s for _, s, e, ln in _kernels_with_launch(t)
              if ln is not None and _inside(coarse, ln))
    return dev / 1e6 / len(t.requests)


# name -> (reader, unit); each moves ``qps`` in the cells that run the program
METRICS = {
    "index.host_ms": (host_ms, "ms/req"),
    "dispatch.wrapper_host_ms": (wrapper_host_ms, "ms/req"),
    "index.coarse_ms": (coarse_ms, "ms/req"),
    "dispatch.alloc_mb_per_req": (alloc_mb_per_req, "MB/req"),
}


def clock_checks(t: SpanTrace) -> dict:
    """The numbers that say the two clocks agree and the spans cover the
    calls: kernels with a launch record; of those, the share launched inside
    a root search span, and of the port's own, inside a ``launch`` span;
    requests holding exactly one root span inside their ``search_device``
    phase; the root spans' share of the phase's time; the share of the idle
    seconds inside ``search_device`` that carry a program span's label."""
    ks = [k for k in _kernels_with_launch(t) if k[3] is not None]
    roots = sorted((t.spans[j][1], t.spans[j][2]) for j in t.roots())
    launches = _spans_named(t, "launch")
    ours = [k for k in ks if _port_rx().search(k[0])]
    one = 0
    for q in t.requests:
        s, e = q["search_device"]
        lo, hi = bisect.bisect_left(roots, (s, -1)), bisect.bisect_left(roots, (e, -1))
        one += hi - lo == 1 and roots[lo][1] <= e
    phase = sum(q["search_device"][1] - q["search_device"][0] for q in t.requests)
    gaps = t.idle_gaps(10**9)
    in_call = sum(v for k, v in gaps if k.startswith("host in search_device"))
    named = sum(v for k, v in gaps if k.startswith("host in search_device: "))
    return {
        "kernels": len(_kernels_with_launch(t)), "kernels_matched": len(ks),
        "matched_share_port": matched_share(t, True),
        "matched_share_other": matched_share(t, False),
        "launch_in_root_share": (sum(_inside(roots, k[3]) for k in ks) / len(ks)
                                 if ks else None),
        "port_launch_in_launch_span_share": (sum(_inside(launches, k[3]) for k in ours)
                                             / len(ours) if ours else None),
        "requests_with_one_root_share": one / len(t.requests) if t.requests else None,
        "root_cover_of_search_device": (sum(e - s for s, e in roots) / phase
                                        if phase else None),
        "idle_in_search_device_named_share": named / in_call if in_call else None,
    }


def stage_split(t: SpanTrace) -> Dict[str, float]:
    """Self time a request of each span name, in ms: a span's duration
    less what its children cover."""
    roots = t.roots()
    child = [0] * len(t.spans)
    for r in t.spans:
        if r[3] >= 0:
            child[r[3]] += r[2] - r[1]
    out: Dict[str, float] = {}
    for j, r in enumerate(t.spans[roots[0]:] if roots else []):
        if r[1] < t.t1_ns:
            out[r[0]] = out.get(r[0], 0.0) + (r[2] - r[1] - child[roots[0] + j]) / 1e6
    return {k: v / len(roots) for k, v in out.items()}


def traced_run(cell: spec.Cell, seed: int, seconds: float, device="cuda",
               trace: bool = True) -> Tuple[dict, dict]:
    """One run of ``cell`` with the program's recorder on; returns (the
    result object, traced: with the span metrics and labelled idle gaps;
    traced: the clock checks, the stage split and the launch records by
    name, untraced: the stage split and the host-side metrics of the
    requests after the warm-up, with no profiler's cost a launch)."""
    import torch
    import torch.profiler

    from nvdb_tpu_torch.eval import trace as program_trace
    from portbench import run
    from portbench import trace as tr

    made = {}
    base_profile = torch.profiler.profile

    class Profile(base_profile):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            # run_cell takes its clock offset right after making the profiler
            made["offset"] = time.time_ns() - time.perf_counter_ns()
            made["prof"] = self

    def make_trace(**kw):
        prof = made.get("prof")
        launches = launch_starts(prof) if prof is not None and kw["activities"] else []
        t = SpanTrace(**kw, spans=program_records(made["tracer"], made["offset"]),
                      launch_ns=launches)
        made["trace"] = t
        return t

    base_readers = spec.metric_readers

    def readers(names, base=spec.HERE):
        out = base_readers([n for n in names if n not in METRICS], base)
        out.update({n: SimpleNamespace(read=METRICS[n][0]) for n in names if n in METRICS})
        return out

    if not trace:
        with program_trace.recording() as tracer:
            result = run.run_cell(cell, seed, seconds, False, device=device)
        recs = program_records(tracer, 0)
        roots = [r for r in recs if r[3] < 0 and r[0] in ROOTS]
        t = SpanTrace(activities=[], requests=[], t0_ns=roots[run.WARMUP_REQUESTS][1],
                      t1_ns=1 << 62, spans=recs)
        extra = {"stage_ms": stage_split(t), **{n: METRICS[n][0](t) for n in (
            "index.host_ms", "dispatch.wrapper_host_ms", "dispatch.alloc_mb_per_req")}}
        return result, extra
    cell = dataclasses.replace(cell, per_layer=list(cell.per_layer) + [
        {"name": n, "unit": u} for n, (_, u) in METRICS.items()])
    with mock.patch.object(torch.profiler, "profile", Profile), \
            mock.patch.object(tr, "Trace", make_trace), \
            mock.patch.object(spec, "metric_readers", readers), \
            program_trace.recording() as tracer:
        made["tracer"] = tracer
        result = run.run_cell(cell, seed, seconds, True, device=device)
    t = made["trace"]
    extra = {"checks": clock_checks(t), "stage_ms": stage_split(t),
             "launch_records": launch_names(made["prof"]) if t.activities else {}}
    return result, extra


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one traced run with the program's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("error: the run needs a CUDA device", file=sys.stderr)
        return 1
    result, extra = traced_run(cell, args.seed, args.seconds, trace=bool(args.trace))
    print(json.dumps(extra), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
