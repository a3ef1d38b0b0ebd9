"""Recall@k against cached or freshly-built ground truth — the reference's
``recall = |GT ∩ ANN| / k`` averaged over queries (nvdb_hnsw_eval.cpp:156-158,
nvdb_ivf_eval.cpp:580-596)."""

from __future__ import annotations

import numpy as np


def recall_at_k(pred_ids: np.ndarray, gt_ids: np.ndarray, k: int | None = None) -> float:
    """pred_ids [Q, >=k], gt_ids [Q, k] -> mean fraction of GT ids retrieved."""
    pred_ids = np.asarray(pred_ids)
    gt_ids = np.asarray(gt_ids)
    if k is None:
        k = gt_ids.shape[1]
    hits = 0
    for p_row, g_row in zip(pred_ids[:, :k], gt_ids[:, :k]):
        hits += len(set(p_row.tolist()) & set(g_row.tolist()))
    return hits / (gt_ids.shape[0] * k)


def candidate_recall(cand_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Fraction of the true top-k present anywhere in the candidate set
    [Q, R >= k]: the ceiling an exact refine stage can reach."""
    cand_ids = np.asarray(cand_ids)
    gt_ids = np.asarray(gt_ids)[:, :k]
    hits = 0
    for c_row, g_row in zip(cand_ids, gt_ids):
        hits += len(set(c_row.tolist()) & set(g_row.tolist()))
    return hits / gt_ids.size
