"""nvdb_tpu_torch — the PyTorch + CUDA port of nvdb_tpu for NVIDIA Hopper.

The layout mirrors ``nvdb_tpu`` module for module, so each counterpart sits
at the same path, and the package exports the same names. Every path of
``nvdb_tpu`` is ported: the exact flat scan, IVF-OPQ-PQ with exact refine,
IVF-Flat, the partition-then-rerank index and their row-sharded forms:

- ``formats``  — vecbin64 / raw12 / gtbin, bit-compatible with ``nvdb_tpu``'s
                 files (bf16 payloads are ``np.uint16`` bits on the host),
                 plus seeded synthetic data.
- ``store``    — padded dtype-aware (f32 / bf16 / int8 + scales, residual
                 int8) store on an explicit torch device, and its row shards.
- ``kernels``  — plain PyTorch ops (the CPU path and the oracles), k-means
                 and PQ training, and the hand-written CUDA kernels for
                 sm_90a (flat top-k, IVF-PQ tables and ADC top-k, exact
                 rerank, IVF probe top-k, the HBM stream), built with nvcc
                 at first use.
- ``index``    — ``FlatIndex`` (with the exact-i8 refine mode), exact ground
                 truth, ``IVFPQIndex``, ``IVFFlatIndex`` and
                 ``PartitionRerankIndex``.
- ``dist``     — row-sharded search over a mesh of devices (one process
                 holding a tensor per shard, or several over
                 ``torch.distributed``), each shard on the same kernels.
- ``eval``     — stats, recall and the benchmark harness (numpy only).
- ``tools``    — the CLIs of ``nvdb_tpu.tools`` (``gpu_sanity`` for
                 ``tpu_sanity``), the A/B tools and the recall probes.

Importing the package loads no kernel library and imports neither jax nor
ml_dtypes.
"""

__version__ = "0.1.0"

from nvdb_tpu_torch.formats import vecbin, gtbin  # noqa: F401
from nvdb_tpu_torch.store import VectorStore  # noqa: F401
from nvdb_tpu_torch.index.flat import FlatIndex, build_ground_truth  # noqa: F401
from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex  # noqa: F401
from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex  # noqa: F401
from nvdb_tpu_torch.index.partition import PartitionRerankIndex  # noqa: F401
