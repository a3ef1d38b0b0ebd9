"""CUDA-graph replay of a served search: the ``search_device`` chains of
every served index (``FlatIndex``, ``IVFPQIndex``, ``PartitionRerankIndex``),
captured once a shape and replayed.

A served call on the card launches a chain of kernels, each from the host:
the flat index's scan (the queries' bf16 rounding, pass 1 and the merge; in
its quantize mode the queries' int8 quantization before and the exact
refine after), or the IVF indexes' rotation, coarse ranking (product, mask
and top-k), candidate scan passes and rerank. Between them the device waits
for the host. ``GraphCache.run`` records the chain once in a ``torch.cuda.CUDAGraph``
and then launches the whole chain with one replay. Every kernel stays as it
is, launched by the same wrapper with the same arguments in the same order:
a replay's answers are bit for bit an eager call's.

When it engages (``engages``): CUDA queries of at least one row, every stage
of the call on the ``cuda`` path (the flat index's metric ``l2`` runs the
plain ops, so it never engages), ``dispatch.DEBUG_NANS`` off (its checks
read back to the host), and the current stream not already capturing.
Every other call runs its chain eagerly (``eager``).

A cache entry is keyed by the batch's shape, dtype and device and by the
parts of the call that shape its chain (``key``): its resolved scalars,
and any store it reads besides the index's own tensors, by identity. It
holds a static query buffer, the graph, the graph's outputs and every part
of the key that is no scalar, so nothing the graph reads is freed under it;
the index's own tensors and its lazy caches (set once, never replaced) live
as long as the index and its cache. A new key: one eager call on a side
stream (cuBLAS, the allocator, the kernels' plans and the index's lazy
caches set up outside the capture), then the capture on that stream, into a
memory pool the index's graphs share. Every capture on a device runs on one
side stream, since cuBLAS keeps a workspace (32 MiB on an H100) for each
stream it runs on. Each call copies its queries into the static buffer,
replays, and returns clones of the outputs, so a caller that keeps one
call's answers does not see the next call's in them. No call reads anything
back to the host.

One index's graphs serve one stream at a time. A lock keeps threads that
share a stream (the default stream, say) from interleaving one entry's copy,
replay and clones; calls from two streams at once would share the entry's
static buffers and the pool's workspace on the device, and are not allowed.

Spans (``eval.trace``): the root span of each call gets the attribute
``graph`` = ``"capture"``, ``"replay"`` or ``"eager"``. The stages' spans are
recorded where the chain runs on the host: each eager call, and the capture
(the warm-up call before it records none); a capture or replay call then
records one ``replay`` span around the copy, the replay and the clones.
``GRAPH_CAPTURES``, ``GRAPH_REPLAYS`` and ``GRAPH_EAGER`` count the calls of
each kind (a capture call serves its answers by a replay, and counts as a
capture alone).

The kernel wrappers' launch counters (the ``*LAUNCHES`` integers and
``LAUNCHES_BY_*`` dicts of the kernel modules) count the kernels that run:
a capture records kernels without running them, so what it added to each
counter is taken back and kept with the entry, and each replay adds it
again. A capture call thus counts its warm-up's launches and its replay's.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.kernels import adc_scan, dispatch, flat_scan, ivf_scan, rerank

# The graphs an index keeps, the least recently used dropped first: a served
# batch size, the host search's last short chunk, and a few A/B settings.
MAX_GRAPHS = 8

GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0
GRAPH_EAGER = 0

Chain = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
_STREAMS: Dict[int, torch.cuda.Stream] = {}   # device index -> its captures' stream
# the modules whose launch counters a replay adds to
_COUNTED = (adc_scan, flat_scan, ivf_scan, rerank)
Counter = Tuple[object, str, object]   # (module, counter's name, dict key or None)


def reset_counts() -> None:
    global GRAPH_CAPTURES, GRAPH_REPLAYS, GRAPH_EAGER
    GRAPH_CAPTURES = GRAPH_REPLAYS = GRAPH_EAGER = 0


def engages(queries: torch.Tensor, paths: Sequence[str]) -> bool:
    """Whether a call on ``queries`` whose stages resolve to ``paths`` is
    served from a graph."""
    return (queries.is_cuda and queries.shape[0] > 0 and all(p == "cuda" for p in paths)
            and not dispatch.DEBUG_NANS and not torch.cuda.is_current_stream_capturing())


def _scalar(p) -> bool:
    return p is None or isinstance(p, (bool, int, float, str))


def key(queries: torch.Tensor, parts: Sequence) -> tuple:
    """The cache key of a call: the batch's shape, dtype and device, then
    ``parts``, each scalar by its value and anything else (a store, a
    tensor) by its identity."""
    return (tuple(queries.shape), queries.dtype, queries.device) + tuple(
        p if _scalar(p) else ("id", id(p)) for p in parts)


def launch_counts() -> Dict[Counter, int]:
    """Every kernel wrapper's launch counter, flat: each ``*LAUNCHES``
    integer and each entry of a ``LAUNCHES_BY_*`` dict of the kernel modules."""
    out = {}
    for mod in _COUNTED:
        for name, v in vars(mod).items():
            if name.endswith("LAUNCHES") and isinstance(v, int):
                out[(mod, name, None)] = v
            elif name.startswith("LAUNCHES_BY_") and isinstance(v, dict):
                out.update(((mod, name, sub), n) for sub, n in v.items())
    return out


def moved(before: Dict[Counter, int]) -> List[Tuple[Counter, int]]:
    """What each counter gained since ``before`` (``launch_counts()``), for
    the counters that moved."""
    return [(c, n - before.get(c, 0)) for c, n in launch_counts().items()
            if n != before.get(c, 0)]


def add_counts(deltas: Sequence[Tuple[Counter, int]], sign: int = 1) -> None:
    """Add ``sign`` times each of ``deltas`` (``moved``) to its counter."""
    for (mod, name, sub), n in deltas:
        if sub is None:
            setattr(mod, name, getattr(mod, name) + sign * n)
        else:
            d = getattr(mod, name)
            d[sub] = d.get(sub, 0) + sign * n


def eager(root, chain: Chain, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``chain`` on ``queries`` as it stands: a call no graph serves."""
    global GRAPH_EAGER
    GRAPH_EAGER += 1
    if root:
        root.attrs["graph"] = "eager"
    return chain(queries)


class _Entry:
    __slots__ = ("graph", "static_q", "outs", "launches", "keep")

    def __init__(self, graph, static_q, outs, launches, keep):
        self.graph = graph
        self.static_q = static_q
        self.outs = outs
        self.launches = launches   # what a replay adds to the launch counters
        self.keep = keep


class GraphCache:
    """One index's captured chains, at most ``MAX_GRAPHS``, least recently
    used dropped first."""

    def __init__(self) -> None:
        self._entries: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
        self._pool = None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def run(self, root, parts: Sequence, queries: torch.Tensor,
            chain: Chain) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve ``chain(queries)`` from the graph of its key, capturing it
        first if there is none. ``parts``: what besides the batch's shape the
        chain depends on (``key``), every store it reads besides the
        index's own tensors among them."""
        global GRAPH_CAPTURES, GRAPH_REPLAYS
        k = key(queries, parts)
        with self._lock:
            entry = self._entries.get(k)
            if entry is None:
                entry = self._capture(queries, parts, chain)
                self._entries[k] = entry
                while len(self._entries) > MAX_GRAPHS:
                    self._entries.popitem(last=False)
                GRAPH_CAPTURES += 1
                label = "capture"
            else:
                self._entries.move_to_end(k)
                GRAPH_REPLAYS += 1
                label = "replay"
            if root:
                root.attrs["graph"] = label
            with trace.span("replay"):
                entry.static_q.copy_(queries)
                entry.graph.replay()
                add_counts(entry.launches)
                return tuple(o.clone() for o in entry.outs)

    def clear(self) -> None:
        """Drop every graph and the pool: the next call of each key captures."""
        with self._lock:
            self._entries.clear()
            self._pool = None

    def _capture(self, queries: torch.Tensor, parts: Sequence, chain: Chain) -> _Entry:
        dev = queries.device
        with torch.cuda.device(dev):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            side = _STREAMS.get(dev.index)
            if side is None:
                side = _STREAMS[dev.index] = torch.cuda.Stream(device=dev)
            static_q = torch.empty(queries.shape, dtype=queries.dtype, device=dev)
            static_q.copy_(queries)
            side.wait_stream(torch.cuda.current_stream(dev))
            with trace.paused(), torch.cuda.stream(side):
                chain(static_q)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                outs = chain(static_q)
            # the capture launched nothing: take back what it counted
            launches = moved(before)
            add_counts(launches, -1)
        keep = tuple(p for p in parts if not _scalar(p))
        return _Entry(graph, static_q, tuple(outs), launches, keep)
