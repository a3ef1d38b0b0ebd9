"""The IVF helpers the IVF-PQ index uses (the port of the helpers of
``nvdb_tpu.index.ivf_flat``): list packing, the coarse probe ranking and
the top-S centroid assignment. ``IVFFlatIndex`` itself arrives with the
``pallas_ivf_probe_topk`` slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.kernels import ops


def _pack_lists(
    rows_enc: np.ndarray,          # [N, D] encoded payload (f32/bf16/i8)
    scales: Optional[np.ndarray],  # [N] f32 for i8
    assign: np.ndarray,            # [N] int32 nearest-centroid
    dists: Optional[np.ndarray],   # [N, S] distances to top-S centroids for spill
    alts: Optional[np.ndarray],    # [N, S] the top-S centroid ids
    nlist: int,
    lcap: int,
    d_padded: int,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]:
    """Pack rows into fixed-capacity lists, spilling overflow to the row's
    next-nearest centroid with free space (lists with free slots as a last
    resort). Fully vectorized (one pass per spill candidate), so packing 100M
    rows is numpy-speed, not a Python loop.
    Returns (packed [nlist, lcap, Dp], slot_ids [nlist, lcap], slot_scales, n_spilled)."""
    n, d = rows_enc.shape
    fill = np.zeros(nlist, dtype=np.int64)
    slot_of = np.full(n, -1, dtype=np.int64)
    list_of = np.full(n, -1, dtype=np.int64)
    spilled = 0

    if alts is None:
        alts = assign[:, None]

    def group_ranks(keys: np.ndarray) -> np.ndarray:
        """Rank of each element within its key group (stable order)."""
        m = keys.shape[0]
        order_ = np.argsort(keys, kind="stable")
        sk = keys[order_]
        is_start = np.r_[True, sk[1:] != sk[:-1]]
        start_pos = np.maximum.accumulate(np.where(is_start, np.arange(m), 0))
        ranks_sorted = np.arange(m) - start_pos
        ranks = np.empty(m, dtype=np.int64)
        ranks[order_] = ranks_sorted
        return ranks

    unplaced = np.arange(n)
    for s in range(alts.shape[1]):
        if unplaced.size == 0:
            break
        cand = alts[unplaced, s].astype(np.int64)
        ranks = group_ranks(cand)
        slots = fill[cand] + ranks
        ok = slots < lcap
        rows_ok = unplaced[ok]
        list_of[rows_ok] = cand[ok]
        slot_of[rows_ok] = slots[ok]
        np.add.at(fill, cand[ok], 1)
        if s > 0:
            spilled += int(rows_ok.size)
        unplaced = unplaced[~ok]

    if unplaced.size:
        # last resort: pour leftovers into whatever lists still have space
        free = lcap - fill
        dest = np.repeat(np.arange(nlist), free)[: unplaced.size]
        if dest.size < unplaced.size:
            raise ValueError("total list capacity too small for all rows")
        ranks = group_ranks(dest)
        list_of[unplaced] = dest
        slot_of[unplaced] = fill[dest] + ranks
        np.add.at(fill, dest, 1)
        spilled += int(unplaced.size)

    packed = np.zeros((nlist, lcap, d_padded), dtype=rows_enc.dtype)
    slot_ids = np.full((nlist, lcap), -1, dtype=np.int32)
    packed[list_of, slot_of, :d] = rows_enc
    slot_ids[list_of, slot_of] = np.arange(n, dtype=np.int32)
    slot_scales = None
    if scales is not None:
        slot_scales = np.ones((nlist, lcap), dtype=np.float32)
        slot_scales[list_of, slot_of] = scales
    return packed, slot_ids, slot_scales, spilled


def _coarse_probes(queries: torch.Tensor, centroids: torch.Tensor,
                   slot_ids: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Coarse top-nprobe lists by L2 (argmax 2 q.c - ||c||^2), full-f32
    products, with EMPTY lists masked out of the ranking: a dead k-means
    centroid keeps its init position, a corpus row, and near the query it
    would outrank the real cell means and burn probe slots on lists with
    no candidate. Returns [B, nprobe] int64."""
    ops.no_tf32()
    qc = queries @ centroids.T
    c2 = torch.sum(centroids * centroids, dim=1)[None, :]
    live = (slot_ids >= 0).any(dim=1)[None, :]
    return torch.topk(torch.where(live, 2.0 * qc - c2, ops.NEG_INF), nprobe, dim=1).indices


def _topS_centroids(data: torch.Tensor, cents: torch.Tensor, s: int,
                    chunk: int = 65536) -> torch.Tensor:
    """[N, Dp] x [K, Dp] -> [N, S] int64 ids of the S nearest centroids (L2),
    chunked over rows, full-f32 products."""
    ops.no_tf32()
    c2 = torch.sum(cents * cents, dim=1)[None, :]
    return torch.cat([torch.topk(2.0 * (data[r:r + chunk] @ cents.T) - c2, s, dim=1).indices
                      for r in range(0, data.shape[0], chunk)])
