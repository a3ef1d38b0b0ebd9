"""The yardstick of the roofline shares: the card's published peaks and a
frozen copy of ``chip_smoke.py``'s ``bound_ms`` arithmetic, with the bytes
and operations of each stage of a batch counted from its inputs (the probe
sets of the benchmark's own coarse ranking and the index's list fills), so
they count the same work whatever implements the stage. A probed list's
bytes count once a batch, however many of its pairs probe it."""

from __future__ import annotations

from typing import Dict

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_GBPS = 3350.0
PEAK_TOPS = {"bf16": 989.0, "int8": 1979.0, "f32": 67.0}   # f32: outside the tensor cores


def bound_ms(nbytes: float, ops: float, kind: str):
    """The least time the card could take: every input byte read once and
    every output byte written once at the HBM rate, or ``ops`` operations at
    the peak rate of their ``kind``, whichever is larger. Returns (ms, which)."""
    t_bytes = nbytes / (HBM_GBPS * 1e9) * 1e3
    t_ops = ops / (PEAK_TOPS[kind] * 1e12) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def probe_counts(probes: torch.Tensor, fills: torch.Tensor, nlist: int) -> Dict[str, torch.Tensor]:
    """Per batch of ``probes`` [NB, B, P] (list ids): ``pairs`` (pairs on a
    live list), ``lists`` (distinct live lists), ``rows`` (their live slots,
    once a list) and ``slots`` (live slots as probed, once a pair)."""
    nb = probes.shape[0]
    pr = probes.reshape(nb, -1).long()
    fl = fills.long()
    live = fl[pr] > 0
    # pairs on an empty list go to a spare column, dropped after
    mask = torch.zeros((nb, nlist + 1), dtype=torch.bool, device=pr.device)
    mask.scatter_(1, torch.where(live, pr, nlist), True)
    mask = mask[:, :nlist]
    return {"pairs": live.sum(1), "lists": mask.sum(1),
            "rows": (mask.long() * fl[None, :]).sum(1),
            "slots": torch.where(live, fl[pr], 0).sum(1)}


def adc_fused_bound(c: Dict[str, float], b: int, p: int, m: int, dsub: int, dp: int,
                    kk: int, codebooks_numel: int) -> float:
    """The fused ADC key scan of one batch (chip_smoke phase 9): bytes, each
    distinct probed list's live codes once, the queries, the distinct probed
    centroids, the codebooks, the probes, the result; operations, every live
    pair's table entries (2 dsub + 4 FLOP each) and every lookup's add, at
    the f32 rate."""
    nbytes = (c["rows"] * m + b * dp * 4 + c["lists"] * dp * 4 + codebooks_numel * 4
              + b * p * 4 + b * kk * 8)
    flops = float(c["pairs"]) * m * 256 * (2 * dsub + 4) + c["slots"] * m
    return bound_ms(nbytes, flops, "f32")[0]


def probe_bound(c: Dict[str, float], b: int, p: int, dp: int, row_bytes: int, k: int,
                kind: str) -> float:
    """The list-major probe of one batch (chip_smoke phase 12,
    ``ivf_scan.probe_bytes``' distinct bytes): each distinct probed list's
    live rows and ids once, the queries, the probes, the result; a
    multiply-add a dimension of every live row of every pair."""
    nbytes = c["rows"] * (row_bytes + 4) + b * dp * 4 + b * p * 4 + b * k * 8
    return bound_ms(nbytes, 2.0 * dp * c["slots"], kind)[0]


def rerank_bound(b: int, r: int, dp: int, k: int) -> float:
    """The exact rerank of one batch of ``r`` candidates a query from an f32
    store (chip_smoke phase 9): each candidate's row, id and norm, the
    queries, the result; a multiply-add a dimension of every candidate."""
    return bound_ms(b * r * (dp * 4 + 8) + b * dp * 4 + b * k * 8, 2.0 * b * r * dp, "f32")[0]
