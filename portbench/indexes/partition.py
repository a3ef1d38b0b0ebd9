"""The partition-then-rerank index, as ``nvdb_tpu_torch`` serves it:
``PartitionRerankIndex.build`` over the corpus rows (a balanced k-means
partition packed in bf16 lists, an f32 rerank store), each request one
``PartitionRerankIndex.search_device`` (the coarse ranking, the list-major
probe kernel, the rerank kernel)."""

from __future__ import annotations

import numpy as np
import torch

from nvdb_tpu_torch.index.partition import PartitionRerankIndex
from portbench.reference import IndexState, sample_live_slots


class Served:
    def __init__(self, cfg: dict, rows: np.ndarray, seed: int, device):
        ix, se = cfg["index"], cfg["search"]
        self.idx = PartitionRerankIndex.build(
            rows, nlist=int(ix["nlist"]), dtype=ix["dtype"], with_refine=True,
            train_size=int(ix["train_size"]), n_iters=int(ix["n_iters"]),
            pad_factor=float(ix["pad_factor"]), spill_candidates=int(ix["spill_candidates"]),
            seed=seed, refine_dtype=ix["refine_store"], device=device)
        self.k, self.nprobe = int(se["k"]), int(se["nprobe"])
        self.rerank_k = int(se["rerank_k"])

    def search(self, q: torch.Tensor):
        return self.idx.search_device(q, self.k, self.nprobe, rerank_k=self.rerank_k)

    def state(self, seed: int) -> IndexState:
        """Copies of the partition and of a sample of the packed rows."""
        ivf = self.idx.ivf
        slots = sample_live_slots(ivf.slot_ids, seed)
        return IndexState(rotation=None, centroids=ivf.centroids.clone(),
                          slot_ids=ivf.slot_ids.clone(), sample_slots=slots,
                          sample_payload=ivf.packed[slots[:, 0], slots[:, 1]].clone())

    def shape(self, batch: int) -> dict:
        """The sizes the per-layer metrics count a batch's work from."""
        ivf = self.idx.ivf
        dp = ivf.packed.shape[2]
        return {"b": batch, "p": min(self.nprobe, ivf.nlist), "dp": dp,
                "row_bytes": dp * ivf.packed.element_size(),
                "payload": "f32" if ivf.packed.dtype == torch.float32 else "bf16",
                "probe_k": self.rerank_k, "k": self.k, "r": self.rerank_k}
