from nvdb_tpu_torch.index.flat import FlatIndex  # noqa: F401
