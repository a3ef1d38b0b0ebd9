"""Stage spans: the port's one recorder (the port of ``nvdb_tpu.eval.trace``).

The reference's observability maps here as:
- steady_clock spans around every stage (nvdb_bench.cpp:24-27) -> ``Tracer.span``;
  on a card a span's ``sync`` is ``torch.cuda.synchronize`` (or a fetch to
  the host), which closes the gap of asynchronous launches before it ends;
- TSV dumps with self-describing file names (nvdb_ivf_eval.cpp:47-126) ->
  ``Tracer.dump_tsv``, which ``tools.ivf_eval`` writes under ``NVDB_DBG_DIR``.

The served path carries spans of its own: ``span(name, **attrs)`` at each
stage of a search (the index's ``search_device``, the coarse ranking, the
candidate and refine stages, each kernel wrapper and its C entry call).
They record only inside ``recording()``, which makes a fresh ``Tracer``
the active recorder; outside it ``span`` returns one shared no-op object,
reads no clock and keeps nothing; ``paused()`` turns the active recorder
off for a block. Each span is a ``Span`` record: name,
start and end on ``time.perf_counter_ns()``, the index of the enclosing
record (-1 for none), a request id (a span opened with no open parent
starts the next id, and its children carry it) and a small dict of
attributes; the kernel wrappers keep one counter there, ``alloc_bytes``
(``Span.count_alloc``), the bytes of the tensors each call allocates.
Records stay in memory until the recorder is read. The recorder serves the
one thread that opens its spans.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional


class Span:
    """One record of a ``Tracer``, and the context manager that times it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "attrs", "_tracer",
                 "_sync")

    def __init__(self, tracer: "Tracer", name: str, sync: Optional[Callable], attrs: dict):
        self.name = name
        self.start_ns = self.end_ns = -1
        self.parent = self.request = -1
        self.attrs = attrs
        self._tracer = tracer
        self._sync = sync

    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr._open:
            self.parent = tr._open[-1]
            self.request = tr.records[self.parent].request
        else:
            self.request = tr._requests
            tr._requests += 1
        tr._open.append(len(tr.records))
        tr.records.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._sync is not None:
            self._sync()
        self.end_ns = time.perf_counter_ns()
        self._tracer._open.pop()

    def count_alloc(self, *tensors) -> None:
        """Add the bytes of ``tensors`` (those not None), each one the span's
        code allocated, to the attribute ``alloc_bytes``."""
        n = sum(t.numel() * t.element_size() for t in tensors if t is not None)
        self.attrs["alloc_bytes"] = self.attrs.get("alloc_bytes", 0) + n


class _Off:
    """What ``span`` returns with no recorder active: enters and exits, and
    is false, so ``if sp:`` skips work done only for the record."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False


OFF = _Off()
_active: Optional["Tracer"] = None


def span(name: str, **attrs):
    """A span of the active recorder, or ``OFF`` when none is active."""
    tracer = _active
    if tracer is None:
        return OFF
    return tracer.span(name, **attrs)


@contextlib.contextmanager
def recording() -> Iterator["Tracer"]:
    """Make a fresh ``Tracer`` the active recorder for the block and yield
    it; the one that was active before (if any) is active again after."""
    global _active
    before, tracer = _active, Tracer()
    _active = tracer
    try:
        yield tracer
    finally:
        _active = before


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """No recorder active for the block (its spans are ``OFF``); the one
    that was active before (if any) is active again after."""
    global _active
    before, _active = _active, None
    try:
        yield
    finally:
        _active = before


class Tracer:
    """Named wall-clock spans, kept as ``Span`` records in opening order."""

    def __init__(self) -> None:
        self.records: List[Span] = []
        self._open: List[int] = []     # indices of the spans not yet closed
        self._requests = 0

    def span(self, name: str, sync: Optional[Callable] = None, **attrs) -> Span:
        """Time a stage. ``sync``: a callable run before the span ends, such
        as ``torch.cuda.synchronize`` or a fetch of the result, so the span
        holds the device's work and not only its launch."""
        return Span(self, name, sync, attrs)

    @property
    def samples_ms(self) -> Dict[str, List[float]]:
        """Each closed span's milliseconds, by name, in opening order."""
        out: Dict[str, List[float]] = defaultdict(list)
        for r in self.records:
            if r.end_ns >= 0:
                out[r.name].append((r.end_ns - r.start_ns) / 1e6)
        return out

    def totals(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self.samples_ms.items()}

    def render(self) -> str:
        lines = []
        for name, v in self.samples_ms.items():
            tot = sum(v)
            lines.append(f"{name}: total={tot:.3f} ms n={len(v)} avg={tot / len(v):.3f} ms")
        return "\n".join(lines)

    def dump_tsv(self, path: str) -> None:
        """Self-describing TSV, one row per (span, sample index, ms): the
        JAX package's columns."""
        with open(path, "w") as f:
            f.write("span\tsample\tms\n")
            for name, v in self.samples_ms.items():
                for i, ms in enumerate(v):
                    f.write(f"{name}\t{i}\t{ms:.6f}\n")
