from nvdb_tpu_torch.store.store import ShardedVectorStore, VectorStore  # noqa: F401
