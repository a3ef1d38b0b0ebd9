"""The exact flat scan, as ``nvdb_tpu_torch`` serves it: a
``VectorStore`` of the corpus rows in the configuration's dtype and a
``FlatIndex`` over it, each request one ``FlatIndex.search_device`` (the
queries' rounding, the tensor-core scan, the merge). For the reference it
is the one-list case of an IVF index: every row sits in list 0, probed by
every query."""

from __future__ import annotations

import numpy as np
import torch

from nvdb_tpu_torch.index.flat import FlatIndex
from nvdb_tpu_torch.store import VectorStore
from portbench.reference import IndexState, sample_live_slots


class Served:
    def __init__(self, cfg: dict, rows: np.ndarray, seed: int, device):
        self.store = VectorStore.from_numpy(rows, cfg["index"]["dtype"], device=device)
        self.idx = FlatIndex(self.store)
        self.k = int(cfg["search"]["k"])

    def search(self, q: torch.Tensor):
        dp = self.store.d_padded
        if q.shape[1] < dp:
            q = torch.nn.functional.pad(q, (0, dp - q.shape[1]))
        return self.idx.search_device(q, self.k)

    def state(self, seed: int) -> IndexState:
        """The one list of every row, and a sample of the stored rows."""
        st = self.store
        slot_ids = torch.arange(st.n, dtype=torch.int32, device=st.device)[None]
        slots = sample_live_slots(slot_ids, seed)
        return IndexState(rotation=None,
                          centroids=torch.zeros((1, st.d_padded), device=st.device),
                          slot_ids=slot_ids, sample_slots=slots,
                          sample_payload=st.vectors[slots[:, 1]].clone())

    def shape(self, batch: int) -> dict:
        """The sizes the per-layer metrics count a batch's work from: the
        published rows and dims, and the padded dims the store holds."""
        st = self.store
        return {"b": batch, "p": 1, "n": st.n, "d": st.d, "dp": st.d_padded, "k": self.k,
                "row_bytes": st.d_padded * st.vectors.element_size()}
