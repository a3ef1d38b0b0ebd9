"""On-disk formats: vecbin64 / raw12 / gtbin, plus converters and synthetic data."""

from nvdb_tpu_torch.formats import vecbin, gtbin, synth  # noqa: F401
