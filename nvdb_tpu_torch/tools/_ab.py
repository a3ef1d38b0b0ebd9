"""The paired-sample timer of the A/B tools (``kernel_ab``, ``refine_ab``,
``adc_ab``): the JAX scripts' methodology (``scripts/kernel_ab.py``,
``refine_ab.py``, ``adc_ab.py``; the reference's Performance_CUDA.md:77-111).

Each arm is a function of no arguments that launches its work and returns
its result. ``paired`` calls each arm once to warm it, then takes ``pairs``
interleaved samples, A, B, A, B, ..., so that drift hits every arm alike.
A sample is ``chain`` chained calls: on a card, CUDA events around them on
the current stream (the device's time); on the CPU, ``time.perf_counter``
until the last result is fetched. A sample is the time per call in ms.

``summary`` reports each arm's mean and ``ci95 = 1.96 * std(ddof=1) /
sqrt(n)``, and the paired delta (arm minus the first arm) with its own CI:
the JAX scripts' formula (``scripts/kernel_ab.py:185-189``). ``device_fields``
gives the ``device=`` and ``power_limit_w=`` of every RESULT line.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def ci95(s: Sequence[float]) -> float:
    """Half-width of the normal 95% interval of the mean (0 for one sample)."""
    s = np.asarray(s, dtype=np.float64)
    return float(1.96 * s.std(ddof=1) / np.sqrt(len(s))) if len(s) > 1 else 0.0


def _fetch(result) -> None:
    """Bring an arm's result to the host: the CPU clock stops after it."""
    for t in (result if isinstance(result, (tuple, list)) else (result,)):
        if torch.is_tensor(t):
            t.cpu()


def sample_ms(fn: Callable, chain: int, device: torch.device) -> float:
    """ms per call of ``chain`` chained calls of ``fn``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / chain
    t0 = time.perf_counter()
    r = None
    for _ in range(chain):
        r = fn()
    _fetch(r)
    return (time.perf_counter() - t0) * 1e3 / chain


def paired(arms: Dict[str, Callable], pairs: int, chain: int,
           device: torch.device) -> Dict[str, List[float]]:
    """{arm: [ms per call of each sample]}: one warm call per arm, then
    ``pairs`` rounds of one sample per arm in the arms' order."""
    for fn in arms.values():
        _fetch(fn())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    samples = {name: [] for name in arms}
    for _ in range(pairs):
        for name, fn in arms.items():
            samples[name].append(sample_ms(fn, chain, device))
    return samples


def summary(samples: Dict[str, List[float]]) -> Dict[str, dict]:
    """{arm: {ms, ci95_ms, delta_ms, delta_ci95_ms}}, the deltas against the
    first arm, sample by sample."""
    names = list(samples)
    ref = np.asarray(samples[names[0]], dtype=np.float64)
    out = {}
    for name in names:
        s = np.asarray(samples[name], dtype=np.float64)
        out[name] = dict(ms=float(s.mean()), ci95_ms=ci95(s), delta_ms=float((s - ref).mean()),
                         delta_ci95_ms=ci95(s - ref))
    return out


def device_fields(device: torch.device) -> dict:
    """``device`` (the card's name, or cpu) and ``power_limit_w`` (nvidia-smi's;
    none on the CPU) of a RESULT line."""
    if device.type != "cuda":
        return dict(device="cpu", power_limit_w="none")
    from nvdb_tpu_torch.bench import power_limit_w

    return dict(device=torch.cuda.get_device_name(device).replace(" ", "_"),
                power_limit_w=power_limit_w(device))
