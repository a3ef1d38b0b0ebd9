"""The traced window: a ``torch.profiler`` trace (CUPTI) of the device's
activity, read into plain intervals, beside the client's own host spans.

``Trace`` holds every device activity (kernels, copies, sets) as (name,
start_ns, end_ns, kind), the host spans of every request of the window (in
the profiler's clock, ``time.time_ns``), and what the per-layer metrics'
readers need to count the work of those requests."""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Tuple

# how the client's host spans name what the host was doing
HOST_PHASES = ("submit", "search_device", "fetch")


@dataclasses.dataclass
class Trace:
    activities: List[Tuple[str, int, int, str]]   # (name, start_ns, end_ns, kind)
    requests: List[dict]                           # HOST_PHASES -> (start_ns, end_ns)
    t0_ns: int
    t1_ns: int
    # the traced requests' work as the readers count it: ``probes`` [NB, B,
    # P] (the reference's coarse ranking of each request's queries),
    # ``fills`` [nlist] (live slots a list), ``shape`` (the index adapter's)
    inputs: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def kernels(self) -> List[Tuple[str, int, int, str]]:
        return [a for a in self.activities if a[3] == "kernel"]

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose names match any of
        ``patterns`` (regular expressions)."""
        rx = re.compile("|".join(patterns))
        return sum(e - s for n, s, e, _ in self.kernels() if rx.search(n)) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of every device activity, clipped to the window."""
        spans = sorted((max(s, self.t0_ns), min(e, self.t1_ns))
                       for _, s, e, _ in self.activities if e > self.t0_ns and s < self.t1_ns)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, int] = {}
        for name, s, e, _ in self.activities:
            tot[name] = tot.get(name, 0) + (e - s)
        return [[name, ns / 1e9] for name, ns in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window by what the host was doing
        at each gap's middle: one of ``HOST_PHASES`` of a request, or
        ``between requests``; the labels with most idle seconds first."""
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for se in busy for x in se] + [self.t1_ns]
        gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
                if edges[j + 1] > edges[j]]
        spans = sorted((r[ph][0], r[ph][1], ph) for r in self.requests for ph in HOST_PHASES)
        starts = [s for s, _, _ in spans]
        tot: Dict[str, int] = {}
        for s, e in gaps:
            mid = (s + e) // 2
            j = bisect.bisect_right(starts, mid) - 1
            label = "between requests"
            if j >= 0 and spans[j][0] <= mid < spans[j][1]:
                label = f"host in {spans[j][2]}"
            tot[label] = tot.get(label, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _kind(name: str) -> str:
    low = name.lower()
    return "copy" if "memcpy" in low else "set" if "memset" in low else "kernel"


def device_activities(prof) -> List[Tuple[str, int, int, str]]:
    """The device-side events of a finished ``torch.profiler.profile``:
    (name, start_ns, end_ns, kind) with kind ``kernel``, ``copy`` or ``set``."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).split(".")[-1] != "CUDA":
            continue
        start = ev.start_ns()
        out.append((ev.name(), start, start + ev.duration_ns(), _kind(ev.name())))
    return out
