"""Plain PyTorch scan / top-k ops (the port of ``nvdb_tpu.kernels.ops``).

They are the CPU path and the oracle the CUDA kernel is checked against.
Numerics follow the JAX ops, which accumulate in f32
(``preferred_element_type``):

- f32 stores multiply in full f32. TF32 is switched off before every f32
  product, the counterpart of ``Precision.HIGHEST``.
- bf16 stores round the query to bf16, then multiply in f32. Products of two
  bf16 values are exact in f32, so only the summation order differs from
  the bf16 matmul with f32 accumulation.
- int8 stores with f32 queries round the query to bf16, widen the codes
  exactly, multiply in f32 and apply the per-row scale after the sum.
- int8 x int8 accumulates exactly: int32 on the CPU, float64 on the card
  (``torch.matmul`` has no integer kernel there; |sum| <= 127^2 * Dp < 2^53).

Ranking follows the CUDA and Pallas kernels: score descending, ties to the
larger id, empty slots as (-inf, -1).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


def _pick_chunk(n_padded: int, row_block: int, target: int) -> int:
    """Largest chunk that divides n_padded, is a multiple of gcd(row_block,
    n_padded), and is <= target."""
    row_block = math.gcd(row_block, n_padded)
    m = n_padded // row_block
    best = 1
    t = 1
    while t * t <= m:
        if m % t == 0:
            for c in (t, m // t):
                if c * row_block <= target and c > best:
                    best = c
        t += 1
    return best * row_block


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bf16_round(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.bfloat16).to(torch.float32)


def score_chunk(
    q: torch.Tensor,                         # [B, D] f32 (or int8 with q_scales)
    chunk: torch.Tensor,                     # [T, D] f32 | bf16 | int8
    scales: Optional[torch.Tensor],          # [T] f32 for int8
    q_scales: Optional[torch.Tensor] = None,  # [B] f32 for int8 queries
) -> torch.Tensor:
    """Dot-product scores [B, T] in f32."""
    cdt = chunk.dtype
    if q.dtype == torch.int8 and cdt == torch.int8:
        acc = torch.float64 if q.is_cuda else torch.int32
        s = (q.to(acc) @ chunk.to(acc).T).to(torch.float32)
        if scales is not None:
            s = s * scales[None, :]
        if q_scales is not None:
            s = s * q_scales[:, None]
        return s
    no_tf32()
    if cdt == torch.float32:
        s = q.to(torch.float32) @ chunk.T
    elif cdt == torch.bfloat16:
        s = _bf16_round(q) @ chunk.to(torch.float32).T
    elif cdt == torch.int8:
        s = _bf16_round(q) @ chunk.to(torch.float32).T
        s = s * scales[None, :]
    else:
        raise ValueError(f"unsupported store dtype {cdt}")
    return s


def merge_topk(vals_a: torch.Tensor, ids_a: torch.Tensor,
               vals_b: torch.Tensor, ids_b: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two candidate sets per query row: [B, ka] + [B, kb] -> [B, k],
    sorted by (score desc, id desc). ``torch.topk`` promises no tie order, so
    it only narrows the set: the C widest of all rows' ``>= k-th value``
    counts keeps every candidate that can enter the top k; the exact order
    is then two stable sorts over that small set."""
    vals = torch.cat([vals_a, vals_b], dim=1)
    ids = torch.cat([ids_a, ids_b], dim=1)
    if vals.shape[1] > k:
        kth = torch.topk(vals, k, dim=1).values[:, -1:]
        c = int((vals >= kth).sum(dim=1).max())
        if c < vals.shape[1]:
            vals, pos = torch.topk(vals, c, dim=1)
            ids = torch.gather(ids, 1, pos)
    order = torch.argsort(ids, dim=1, descending=True, stable=True)
    vals, ids = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
    order = torch.argsort(vals, dim=1, descending=True, stable=True)
    vals, ids = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
    return vals[:, :k], ids[:, :k]


def scan_topk(
    queries: torch.Tensor,            # [B, Dp] f32 (dims already padded)
    vectors: torch.Tensor,            # [Np, Dp]
    scales: Optional[torch.Tensor],   # [Np] f32 or None
    n_valid: int,                     # rows >= n_valid are padding
    k: int,
    row_block: int = 1024,
    chunk_target: int = 131072,
    query_scales: Optional[torch.Tensor] = None,  # [B] f32 for int8 queries
    metric: str = "dot",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact flat-scan top-k over row chunks with a running top-k. Returns
    (scores [B, k] f32, ids [B, k] int32) sorted descending; slots beyond the
    valid rows hold (-inf, -1).

    ``metric="dot"`` ranks by the dot product; ``metric="l2"`` ranks by
    2 q.r - ||r||^2 (monotone in -L2), folding the int8 scale as
    s^2 * ||codes||^2. int8 queries are dot-only."""
    if metric not in ("dot", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "l2" and query_scales is not None:
        raise ValueError("metric='l2' requires f32 queries")
    B = queries.shape[0]
    Np = vectors.shape[0]
    dev = vectors.device
    chunk = _pick_chunk(Np, row_block, chunk_target)
    n_valid = int(n_valid)

    vals = torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, min(n_valid, Np), chunk):
        tile = vectors[c0:c0 + chunk]
        s_tile = scales[c0:c0 + chunk] if scales is not None else None
        scores = score_chunk(queries, tile, s_tile, query_scales)
        if metric == "l2":
            n2 = torch.sum(tile.to(torch.float32) ** 2, dim=1)
            if s_tile is not None:
                n2 = n2 * s_tile * s_tile
            scores = 2.0 * scores - n2[None, :]
        gids = torch.arange(c0, c0 + tile.shape[0], dtype=torch.int32, device=dev)
        valid = gids < n_valid
        scores = torch.where(valid[None, :], scores, NEG_INF)
        gids = torch.where(valid, gids, -1)
        vals, ids = merge_topk(vals, ids, scores, gids.expand(B, -1), k)
    return vals, ids


def topk_sorted(vals: torch.Tensor, ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of a [B, W] candidate set by (score desc, id desc), padded
    with (-inf, -1) when W < k."""
    B = vals.shape[0]
    empty_v = torch.full((B, 0), NEG_INF, dtype=torch.float32, device=vals.device)
    empty_i = torch.full((B, 0), -1, dtype=torch.int32, device=vals.device)
    v, i = merge_topk(empty_v, empty_i, vals, ids.to(torch.int32), k)
    if v.shape[1] < k:
        pad = k - v.shape[1]
        v = torch.cat([v, torch.full((B, pad), NEG_INF, device=v.device)], dim=1)
        i = torch.cat([i, torch.full((B, pad), -1, dtype=torch.int32, device=i.device)],
                      dim=1)
    return v, i


def exact_rerank(
    queries: torch.Tensor,        # [B, Dp] f32
    cand_vectors: torch.Tensor,   # [B, R, Dp] f32 (already gathered + dequantized)
    cand_ids: torch.Tensor,       # [B, R] int32 (may contain -1 padding)
    k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of gathered candidates (the port of
    ``nvdb_tpu.kernels.ops.exact_rerank``). ``metric="l2"`` ranks by
    2 q.c - ||c||^2 (negated squared L2 up to ||q||^2), ``"dot"`` by q.c;
    products in full f32 (TF32 off). Returns (scores [B, k], ids [B, k])
    by (score desc, id desc); -1 candidates never rank."""
    no_tf32()
    dots = torch.einsum("bd,brd->br", queries.to(torch.float32),
                        cand_vectors.to(torch.float32))
    if metric == "l2":
        scores = 2.0 * dots - torch.sum(cand_vectors.to(torch.float32) ** 2, dim=-1)
    elif metric == "dot":
        scores = dots
    else:
        raise ValueError(f"unknown metric {metric!r}")
    valid = cand_ids >= 0
    scores = torch.where(valid, scores, NEG_INF)
    return topk_sorted(scores, torch.where(valid, cand_ids, -1), k)


def dedup_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse duplicate ids in a [B, W] candidate set, keeping each id's
    best score, then take the top k (the port of
    ``nvdb_tpu.kernels.ops.dedup_topk``, for replicated indexes)."""
    # stable sorts: by score desc, then by id, so each id group starts at
    # its best score
    order = torch.argsort(vals, dim=1, descending=True, stable=True)
    sv, si = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
    order = torch.argsort(si, dim=1, stable=True)
    sv, si = torch.gather(sv, 1, order), torch.gather(si, 1, order)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    sv = torch.where(dup, NEG_INF, sv)
    si = torch.where(dup, -1, si)
    return topk_sorted(sv, si, k)
