"""nvdb_tpu_torch — the PyTorch + CUDA port of nvdb_tpu for NVIDIA Hopper.

The layout mirrors ``nvdb_tpu`` module for module, so each counterpart sits
at the same path. This slice carries the exact flat-scan path:

- ``formats``  — vecbin64 / raw12 / gtbin, bit-compatible with ``nvdb_tpu``'s
                 files (bf16 payloads are ``np.uint16`` bits on the host),
                 plus seeded synthetic data.
- ``store``    — padded dtype-aware (f32 / bf16 / int8 + scales) store on an
                 explicit torch device.
- ``kernels``  — plain PyTorch scan / top-k ops (the CPU path and the oracle)
                 and the hand-written CUDA flat top-k kernel for sm_90a,
                 built with nvcc at first use.
- ``index``    — ``FlatIndex`` and exact ground truth.
- ``eval``     — stats, recall and the benchmark harness (numpy only).
- ``tools``    — the ``bench`` CLI.

Importing the package loads no kernel library and imports neither jax nor
ml_dtypes.
"""

__version__ = "0.1.0"

from nvdb_tpu_torch.formats import vecbin, gtbin  # noqa: F401
from nvdb_tpu_torch.store import VectorStore  # noqa: F401
from nvdb_tpu_torch.index.flat import FlatIndex, build_ground_truth  # noqa: F401
