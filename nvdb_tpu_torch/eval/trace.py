"""Stage spans and their TSV dump (the port of ``nvdb_tpu.eval.trace``).

The reference's observability maps here as:
- steady_clock spans around every stage (nvdb_bench.cpp:24-27) -> ``Tracer.span``;
  on a card a span's ``sync`` is ``torch.cuda.synchronize`` (or a fetch to
  the host), which closes the gap of asynchronous launches before it ends;
- TSV dumps with self-describing file names (nvdb_ivf_eval.cpp:47-126) ->
  ``Tracer.dump_tsv``, which ``tools.ivf_eval`` writes under ``NVDB_DBG_DIR``;
- Nsight counters -> ``torch_profile``, a ``torch.profiler`` trace of the
  CPU and the card. No default run turns it on: kernel times are taken with
  CUDA events (``chip_smoke.cuda_ms``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class Tracer:
    """Named wall-clock spans, a list of samples per span."""

    def __init__(self) -> None:
        self.samples_ms: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync=None) -> Iterator[None]:
        """Time a stage. ``sync``: a callable run before the span ends, such
        as ``torch.cuda.synchronize`` or a fetch of the result, so the span
        holds the device's work and not only its launch."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.samples_ms[name].append((time.perf_counter() - t0) * 1e3)

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


@contextlib.contextmanager
def torch_profile(log_dir: str) -> Iterator[str]:
    """Record a ``torch.profiler`` trace of the CPU and, where there is one,
    the card into ``log_dir/trace.json`` (chrome trace format); yields
    ``log_dir``. The analogue of the JAX package's ``jax_profile``."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
