"""The IVF-OPQ-PQ index with an exact f32 refine, as ``nvdb_tpu_torch``
serves it: ``IVFPQIndex.build`` over the corpus rows, an f32
``VectorStore`` of the same rows for the refine, and each request one
``IVFPQIndex.search_device`` (the coarse ranking, the fused ADC key scan,
the rerank kernel)."""

from __future__ import annotations

import numpy as np
import torch

from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
from nvdb_tpu_torch.store import VectorStore
from portbench.reference import IndexState


class Served:
    def __init__(self, cfg: dict, rows: np.ndarray, seed: int, device):
        ix, se = cfg["index"], cfg["search"]
        self.idx = IVFPQIndex.build(
            rows, nlist=int(ix["nlist"]), m=int(ix["m"]), use_opq=bool(ix["opq"]),
            train_size=int(ix["train_size"]), n_iters=int(ix["n_iters"]),
            opq_iters=int(ix["opq_iters"]), pad_factor=float(ix["pad_factor"]),
            spill_candidates=int(ix["spill_candidates"]), seed=seed, device=device)
        self.store = VectorStore.from_numpy(rows, ix["refine_store"], device=device)
        self.k, self.nprobe = int(se["k"]), int(se["nprobe"])
        self.refine_k = int(se["refine_k"])

    def search(self, q: torch.Tensor):
        return self.idx.search_device(q, self.k, self.nprobe, refine_k=self.refine_k,
                                      refine_store=self.store)

    def state(self, seed: int) -> IndexState:
        """Copies of the quantizer and of the codes."""
        ix = self.idx
        return IndexState(
            rotation=None if ix.rotation is None else ix.rotation.clone(),
            centroids=ix.centroids.clone(), slot_ids=ix.slot_ids.clone(),
            replicas=ix.replicas, codes=ix.codes.clone(), codebooks=ix.codebooks.clone())

    def shape(self, batch: int) -> dict:
        """The sizes the per-layer metrics count a batch's work from."""
        ix = self.idx
        return {"b": batch, "p": min(self.nprobe, ix.nlist), "m": ix.m,
                "dsub": ix.codebooks.shape[2], "dp": ix.centroids.shape[1],
                "kk": max(self.k, self.refine_k), "k": self.k, "r": self.refine_k,
                "codebooks_numel": ix.codebooks.numel()}
