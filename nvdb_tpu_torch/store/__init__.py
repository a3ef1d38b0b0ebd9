from nvdb_tpu_torch.store.store import VectorStore  # noqa: F401
